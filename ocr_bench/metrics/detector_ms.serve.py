"""Detector: BatchedOCR.detector_scores (s2d prefix, kernel #5, the VGG
trunk, kernel #1), device ms a dispatch."""
from ocr_bench.readers import mean_device_ms


def read(rec):
    return mean_device_ms(rec, "ocr_bench.detector_scores")
