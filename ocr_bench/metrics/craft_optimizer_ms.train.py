"""CRAFT train step: device ms of the kernels launched in the program's span
train.optimizer (apply_craft_update: the gradients reduced, frozen ones zeroed, the global-norm clip and Adam), a step (a span train.step)."""
from ocr_bench import spans


def read(rec):
    return spans.device_ms(rec["trace"], "train.optimizer", "train.step")
