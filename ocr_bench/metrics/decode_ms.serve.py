"""Host decode, read in the program: host ms of its span ocr.decode (the
four copies to the host and the strings), a dispatch."""
from ocr_bench import spans


def read(rec):
    return spans.host_ms(rec["trace"], "ocr.decode", "ocr.dispatch")
