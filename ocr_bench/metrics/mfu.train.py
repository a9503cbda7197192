"""Whole step: forward and backward operations a sample (counted once on
the plain reference) times the samples a second of the traced window,
over the float32 peak (TF32 off), in %."""
from ocr_bench.counts.kernels import PEAK_FP32_FLOPS


def read(rec):
    a, b = rec["traced"]
    done = [ask for ask, _ in rec["steps"] if a < ask <= b][1:]  # each ask follows a finished step
    flops = rec.get("flops_per_sample")
    if not flops or not done or not rec["trace"].device:
        return None
    return 100.0 * flops * len(done) * rec["batch"] / (b - a) / PEAK_FP32_FLOPS
