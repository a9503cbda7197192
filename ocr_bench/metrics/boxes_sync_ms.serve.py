"""Boxes: host ms of the ocr.sync spans inside the program's span ocr.boxes
(the boolean-mask indexings of get_det_boxes, the dummy rect), a
dispatch: the box stage's waits for the card."""
from ocr_bench import spans


def read(rec):
    return spans.child_ms(rec["trace"], "ocr.boxes", "ocr.sync", "ocr.dispatch")
