"""CRNN train step: host ms of the program's span train.sync (Trainer.fit
reads each step's loss back), a step."""
from ocr_bench import spans


def read(rec):
    return spans.host_ms(rec["trace"], "train.sync", "train.step")
