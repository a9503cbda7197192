"""CRNN train step (train/train_step.py): device ms of the kernels launched
in the span around Trainer.train_step, a step."""
from ocr_bench.readers import mean_device_ms


def read(rec):
    return mean_device_ms(rec, "ocr_bench.train_step", per="ocr_bench.train_step")
