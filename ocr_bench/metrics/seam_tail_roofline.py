"""Kernel #1 (csrc/seam_tail.cu): its least time at the dispatch's shapes
(counts/kernels.py) over the device time of the kernels in the
program's span seam_tail, in %."""
from ocr_bench.counts.kernels import tail_bound_ms
from ocr_bench.readers import roofline


def read(rec):
    return roofline(rec, "seam_tail", lambda B, H, W: tail_bound_ms(B, H // 2, W // 2)[0])
