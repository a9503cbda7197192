"""CRAFT training data: host ms of the program's span craft.data (fit_craft
drawing a batch from craft_batches: synthesize_batch on the step's thread),
a step (a span train.step)."""
from ocr_bench import spans


def read(rec):
    return spans.host_ms(rec["trace"], "craft.data", "train.step")
