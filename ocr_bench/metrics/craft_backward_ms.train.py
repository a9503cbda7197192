"""CRAFT train step: device ms of the kernels launched in the program's span
train.backward (loss.backward(); autograd launches from a thread of its own while the span is open), a step (a span train.step)."""
from ocr_bench import spans


def read(rec):
    return spans.device_ms(rec["trace"], "train.backward", "train.step")
