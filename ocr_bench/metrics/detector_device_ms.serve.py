"""Detector, read in the program: device ms of the kernels launched in its
span ocr.detector (BatchedOCR.detector_scores), a dispatch."""
from ocr_bench import spans


def read(rec):
    return spans.device_ms(rec["trace"], "ocr.detector", "ocr.dispatch")
