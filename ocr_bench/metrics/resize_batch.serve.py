"""Host prep: the mean of the program's counter ocr.prepare.resize_batch
(the images of each batched resize in BatchedOCR.prepare) over the traced
part; None where the program keeps no such counter."""
from ocr_bench import spans


def read(rec):
    return spans.counter_mean(rec, "ocr.prepare.resize_batch")
