"""Training loader: host ms of the program's span loader.collate (a batch's
images resized and collated, in a loader thread), a batch."""
from ocr_bench import spans


def read(rec):
    return spans.host_ms(rec["trace"], "loader.collate", "loader.batch")
