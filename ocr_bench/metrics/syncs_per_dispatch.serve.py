"""Whole dispatch: the program's ocr.sync spans (one a host sync) inside a
span ocr.dispatch, on the mean."""
from ocr_bench import spans


def read(rec):
    return spans.count_in(rec["trace"], "ocr.sync", "ocr.dispatch")
