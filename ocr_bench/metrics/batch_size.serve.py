"""Worker queue: the mean of the program's counter worker.batch_size (the
requests of each batch the InferenceWorker takes) over the traced part."""
from ocr_bench import spans


def read(rec):
    return spans.counter_mean(rec, "worker.batch_size")
