"""CRAFT training data: the mean of the program's counter craft.upload_bytes
(the host bytes fit_craft copies to the card for a step) over the traced
part, in MB; None where the program keeps no such counter."""
from ocr_bench import spans


def read(rec):
    v = spans.counter_mean(rec, "craft.upload_bytes")
    return None if v is None else v / 1e6
