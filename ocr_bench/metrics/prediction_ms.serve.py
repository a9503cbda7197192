"""Recognizer's attention head: device ms of the kernels launched in the
program's span crnn.prediction (the greedy decode loop), a dispatch."""
from ocr_bench import spans


def read(rec):
    return spans.device_ms(rec["trace"], "crnn.prediction", "ocr.dispatch")
