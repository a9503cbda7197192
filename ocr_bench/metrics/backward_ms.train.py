"""CRNN train step's backward: device ms of the kernels launched while the
program's span train.backward is open (autograd launches from a thread of
its own), a step."""
from ocr_bench import spans


def read(rec):
    return spans.device_ms(rec["trace"], "train.backward", "train.step")
