"""CRNN train step: device operations launched in the program's span
train.step, a step."""
from ocr_bench import spans


def read(rec):
    return spans.kernels(rec["trace"], "train.step")
