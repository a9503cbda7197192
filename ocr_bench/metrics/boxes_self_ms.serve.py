"""Boxes: host ms of the program's span ocr.boxes less its ocr.sync
children (the host syncs), a dispatch: the box stage's own host work."""
from ocr_bench import spans


def read(rec):
    return spans.self_ms(rec["trace"], "ocr.boxes", "ocr.sync", "ocr.dispatch")
