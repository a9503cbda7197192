"""CRAFT train step: device ms of the kernels launched in the program's span
craft.ohem (both ohem_mse calls of craft_loss), a step (a span train.step)."""
from ocr_bench import spans


def read(rec):
    return spans.device_ms(rec["trace"], "craft.ohem", "train.step")
