"""Training loader: host ms of the program's span loader.decode (a batch's
records read and decoded, in a loader thread), a batch."""
from ocr_bench import spans


def read(rec):
    return spans.host_ms(rec["trace"], "loader.decode", "loader.batch")
