"""CRNN train step's optimizer: device ms of the kernels launched in the
program's span train.optimizer (the global-norm clip and Adadelta), a
step."""
from ocr_bench import spans


def read(rec):
    return spans.device_ms(rec["trace"], "train.optimizer", "train.step")
