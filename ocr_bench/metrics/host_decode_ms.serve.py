"""Host decode: BatchedOCR.decode (tokens to texts), host ms a dispatch."""
from ocr_bench.readers import mean_host_ms


def read(rec):
    return mean_host_ms(rec, "ocr_bench.decode")
