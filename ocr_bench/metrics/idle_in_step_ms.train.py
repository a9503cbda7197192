"""CRNN train step: ms of the program's spans train.step in which the card
ran nothing, a step."""
from ocr_bench import spans


def read(rec):
    return spans.idle_ms(rec["trace"], "train.step", "train.step")
