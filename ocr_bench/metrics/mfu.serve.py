"""Whole dispatch: the work of the receipts and of the boxes that carried
a word (the detector at the receipt's canvas, the recognizer a box,
counted once on the plain reference), answered a second in the traced
window, over the bf16 peak, in %.  Box slots left empty are padding, not
work."""
from ocr_bench.counts.kernels import PEAK_BF16_FLOPS
from ocr_bench.readers import answered_per_s


def read(rec):
    det, box = rec.get("flops_detector"), rec.get("flops_per_box")
    if not det or not rec["trace"].device:
        return None
    receipts, boxes = answered_per_s(rec)
    return 100.0 * (det * receipts + box * boxes) / PEAK_BF16_FLOPS if receipts else None
