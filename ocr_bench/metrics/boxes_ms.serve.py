"""Boxes: BatchedOCR.boxes (kernel #2, get_det_boxes, the rect mapping),
host ms a dispatch: it waits on the card several times, so its wall time
is its cost."""
from ocr_bench.readers import mean_host_ms


def read(rec):
    return mean_host_ms(rec, "ocr_bench.boxes")
