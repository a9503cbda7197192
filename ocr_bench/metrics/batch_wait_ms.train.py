"""Training loader, read in the program: host ms of its span loader.wait
(the step's wait for its batch in DataLoader.__iter__), a step (a span
train.step)."""
from ocr_bench import spans


def read(rec):
    return spans.host_ms(rec["trace"], "loader.wait", "train.step")
