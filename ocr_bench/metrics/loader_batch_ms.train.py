"""Training loader: host ms of the program's span loader.batch (one batch
made in a loader thread: its records decoded, then collated), a batch."""
from ocr_bench import spans


def read(rec):
    return spans.host_ms(rec["trace"], "loader.batch", "loader.batch")
