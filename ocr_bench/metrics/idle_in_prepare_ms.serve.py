"""Host prep: ms of the program's spans ocr.prepare in which the card ran
nothing, a dispatch."""
from ocr_bench import spans


def read(rec):
    return spans.idle_ms(rec["trace"], "ocr.prepare", "ocr.dispatch")
