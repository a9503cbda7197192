"""Detector prefix: device ms of the kernels launched in the program's span
ocr.detector.prefix (conv1_1, s2d_prefix on the tail,s2d plan), a
dispatch."""
from ocr_bench import spans


def read(rec):
    return spans.device_ms(rec["trace"], "ocr.detector.prefix", "ocr.dispatch")
