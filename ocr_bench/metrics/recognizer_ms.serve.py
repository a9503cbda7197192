"""Recognizer: BatchedOCR.recognize (crops, TPS, ResNet, BiLSTM, attention
decode), device ms a dispatch."""
from ocr_bench.readers import mean_device_ms


def read(rec):
    return mean_device_ms(rec, "ocr_bench.recognize")
