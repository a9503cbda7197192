"""Kernel #5 (csrc/stem.cu, conv1_2 + pool): its least time at the
dispatch's canvas over the device time of the kernels in the program's span
conv12_pool, in %."""
from ocr_bench.counts.kernels import stem_bound_ms
from ocr_bench.readers import roofline


def read(rec):
    return roofline(rec, "conv12_pool", lambda B, H, W: stem_bound_ms(B, H, W)[0])
