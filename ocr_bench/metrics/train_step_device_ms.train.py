"""CRNN train step, read in the program: device ms of the kernels launched
in its span train.step (make_train_step's step), a step."""
from ocr_bench import spans


def read(rec):
    return spans.device_ms(rec["trace"], "train.step", "train.step")
