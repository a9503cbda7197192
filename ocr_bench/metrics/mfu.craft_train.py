"""Whole CRAFT step: forward and backward operations a sample (counted once
on the plain reference, counts/craft_train.py) times the samples of the
program's train.step spans whose kernels all end inside the traced part,
over its seconds, in % of the float32 peak (TF32 off)."""
from ocr_bench.counts.kernels import PEAK_FP32_FLOPS


def read(rec):
    tr = rec["trace"]
    flops = rec.get("flops_per_sample")
    if not flops or not tr.device:
        return None
    done = 0
    for s in tr.spans("train.step"):
        ks = tr.span_kernels(s)
        if ks and max(k["ts"] + k["dur"] for k in ks) <= tr.t1:
            done += 1
    if not done:
        return None
    return 100.0 * flops * done * rec["batch"] / tr.window_s / PEAK_FP32_FLOPS
