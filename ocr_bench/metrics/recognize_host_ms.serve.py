"""Recognizer: host ms of the program's span ocr.recognize, a dispatch: the
time the host takes to launch it (it holds no sync)."""
from ocr_bench import spans


def read(rec):
    return spans.host_ms(rec["trace"], "ocr.recognize", "ocr.dispatch")
