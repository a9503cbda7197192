"""Host prep, read in the program: host ms of its span ocr.prepare
(BatchedOCR.prepare: resize on the card, gray luma, the uploads), a
dispatch (a span ocr.dispatch)."""
from ocr_bench import spans


def read(rec):
    return spans.host_ms(rec["trace"], "ocr.prepare", "ocr.dispatch")
