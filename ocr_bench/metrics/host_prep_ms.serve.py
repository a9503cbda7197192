"""Host prep: BatchedOCR.group and .prepare (resize on the card, gray luma,
H2D), host ms a dispatch."""
from ocr_bench.readers import mean_host_ms


def read(rec):
    return mean_host_ms(rec, "ocr_bench.group", "ocr_bench.prepare")
