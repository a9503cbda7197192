"""Recognizer's ResNet: device ms of the kernels launched in the program's
span crnn.features, a dispatch."""
from ocr_bench import spans


def read(rec):
    return spans.device_ms(rec["trace"], "crnn.features", "ocr.dispatch")
