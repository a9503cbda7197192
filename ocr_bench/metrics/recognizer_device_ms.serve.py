"""Recognizer, read in the program: device ms of the kernels launched in its
span ocr.recognize (crops, TPS, ResNet, BiLSTM, attention decode), a
dispatch."""
from ocr_bench import spans


def read(rec):
    return spans.device_ms(rec["trace"], "ocr.recognize", "ocr.dispatch")
