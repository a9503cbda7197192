"""CRAFT training data: host ms of the program's span craft.upload
(fit_craft's batch_to), a step (a span train.step).  The copy is from
pageable host memory, so the host waits there until the card has run the
work queued before it: the span holds the wait behind the previous step as
well as the copy."""
from ocr_bench import spans


def read(rec):
    return spans.host_ms(rec["trace"], "craft.upload", "train.step")
