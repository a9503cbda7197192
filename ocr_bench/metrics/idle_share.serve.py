"""The card's idle share of the traced window, in %."""
from ocr_bench.readers import idle_share


def read(rec):
    return idle_share(rec)
