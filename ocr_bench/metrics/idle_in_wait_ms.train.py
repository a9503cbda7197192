"""Training loader: ms of the program's spans loader.wait in which the card
ran nothing, a step."""
from ocr_bench import spans


def read(rec):
    return spans.idle_ms(rec["trace"], "loader.wait", "train.step")
