"""CRNN train step's forward: device ms of the kernels launched in the
program's span train.forward (loss_fn), a step."""
from ocr_bench import spans


def read(rec):
    return spans.device_ms(rec["trace"], "train.forward", "train.step")
