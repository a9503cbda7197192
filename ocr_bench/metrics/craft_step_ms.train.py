"""CRAFT train step (train/craft.py::make_craft_train_step): device ms of the
kernels launched in the program's span train.step, a step."""
from ocr_bench import spans


def read(rec):
    return spans.device_ms(rec["trace"], "train.step", "train.step")
