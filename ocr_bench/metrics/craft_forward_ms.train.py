"""CRAFT train step: device ms of the kernels launched in the program's span
train.forward (the model call inside craft_loss), a step (a span train.step)."""
from ocr_bench import spans


def read(rec):
    return spans.device_ms(rec["trace"], "train.forward", "train.step")
