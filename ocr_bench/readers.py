"""Helpers of the per-layer metric readers (``metrics/<name>.py``).

A reader takes the traced run's records: ``trace`` (a ``trace.Trace`` of
the traced part of the window), ``traced`` (its start and end on the
host's ``perf_counter``), and the driver's own records (``dispatches``,
``requests``, ``steps``, ``flops_detector``, ``flops_per_box``,
``flops_per_sample``).
It returns a number, or None where it finds nothing to read; a share of a
peak or a roofline is never made up as 0.
"""
from __future__ import annotations


def mean_host_ms(rec, *names):
    """Mean over the traced part's dispatches of the summed host time of
    the spans ``names`` (the benchmark's spans around the program's
    stages)."""
    tr = rec["trace"]
    n = len(tr.spans("ocr_bench.dispatch"))
    total = sum(e["dur"] for name in names for e in tr.spans(name))
    return total / 1e3 / n if n else None


def mean_device_ms(rec, name, per="ocr_bench.dispatch"):
    """Mean a ``per`` span of the device time of the kernels launched in
    the spans ``name``."""
    tr = rec["trace"]
    n = len(tr.spans(per))
    if not n or not tr.device:
        return None
    return sum(tr.span_device_ms(s) for s in tr.spans(name)) / n


def shaped(rec, name):
    """[(span, (B, H, W))]: each of the program's spans ``name`` with the
    canvas batch of the ``ocr_bench.shape.BxHxW`` span around it."""
    tr = rec["trace"]
    shapes = [s for s in tr.host if s["name"].startswith("ocr_bench.shape.")]
    out = []
    for s in tr.spans(name):
        for sh in shapes:
            if sh["tid"] == s["tid"] and sh["ts"] <= s["ts"] and s["ts"] + s["dur"] <= sh["ts"] + sh["dur"]:
                out.append((s, tuple(int(v) for v in sh["name"].rsplit(".", 1)[1].split("x"))))
                break
    return out


def roofline(rec, name, bound_ms):
    """100 x the least time ``bound_ms(B, H, W)`` summed over the spans
    ``name``, over the device time of their kernels."""
    tr = rec["trace"]
    pairs = shaped(rec, name)
    spent = sum(tr.span_device_ms(s) for s, _ in pairs)
    if not pairs or spent <= 0:
        return None
    return 100.0 * sum(bound_ms(*shape) for _, shape in pairs) / spent


def idle_share(rec):
    tr = rec["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s) if tr.device else None


def answered_per_s(rec):
    """(receipts, boxes that carried a word) answered in the traced part,
    a second."""
    a, b = rec["traced"]
    done = [n for _, _, d, n in rec["requests"] if d is not None and a <= d <= b]
    return len(done) / (b - a), sum(n or 0 for n in done) / (b - a)

