"""Worker queue: the mean of the program's counter worker.queue_wait_s (a
request's time from InferenceWorker.submit until its batch is taken) over
the traced part, in ms."""
from ocr_bench import spans


def read(rec):
    v = spans.counter_mean(rec, "worker.queue_wait_s")
    return None if v is None else 1e3 * v
