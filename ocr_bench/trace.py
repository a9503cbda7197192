"""The traced run's records: ``torch.profiler`` over the host and the card,
read back from its Chrome trace.

Spans are ``record_function`` ranges (the benchmark's own, named
``ocr_bench.*``, and the program's, such as ``seam_tail``).  A span's device
time is the time of the kernels launched while it is open, on any thread
(autograd launches the backward from a thread of its own; in each cell one
thread at a time launches), matched by the profiler's correlation ids, so
work queued in a span counts there whenever the card runs it.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "ocr_bench.window"


@contextlib.contextmanager
def profiled(path: str):
    """Profile the host's threads and the card; write the Chrome trace to
    ``path`` and yield a dict that holds its events afterwards."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    if "profile_all_threads" in (_ExperimentalConfig.__init__.__doc__ or ""):
        kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    box = {}
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, **kw) as prof:
        yield box
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        box["events"] = json.load(f)["traceEvents"]
    os.remove(path)


def union_us(spans) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


class Trace:
    """Events of one traced window (the span named ``WINDOW``)."""

    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError("the trace holds no window span")
        self.t0 = win[0]["ts"]
        self.t1 = win[0]["ts"] + win[0]["dur"]
        timed = [e for e in events if "dur" in e and e.get("ph") == "X"]
        self.device = [e for e in timed if e.get("cat") in DEVICE_CATS]
        self.runtime = [e for e in timed if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        self.host = [e for e in timed if e.get("cat") in ("cpu_op", "user_annotation", "python_function")]
        self.by_corr = defaultdict(list)
        for e in self.device:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                self.by_corr[c].append(e)
        self.launches = sorted((e["ts"], e["args"]["correlation"]) for e in self.runtime
                               if e.get("args", {}).get("correlation") is not None)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def in_window(self, e) -> bool:
        return self.t0 <= e["ts"] and e["ts"] + e["dur"] <= self.t1

    def busy_s(self) -> float:
        """Seconds of the window in which the card ran an operation."""
        return union_us((max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1))
                        for e in self.device if e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0) / 1e6

    def spans(self, name: str) -> list:
        """The window's spans of ``name``, in order."""
        return sorted((e for e in self.host if e["name"] == name and e.get("cat") == "user_annotation"
                       and self.in_window(e)), key=lambda e: e["ts"])

    def span_kernels(self, span) -> list:
        """Device operations launched while the span is open."""
        seq = self.launches
        lo = bisect.bisect_left(seq, (span["ts"], -1))
        hi = bisect.bisect_right(seq, (span["ts"] + span["dur"], float("inf")))
        return [k for _, c in seq[lo:hi] for k in self.by_corr.get(c, ())]

    def span_device_ms(self, span) -> float:
        return sum(k["dur"] for k in self.span_kernels(span)) / 1e3

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by what the host was doing in their middle."""
        by_name = defaultdict(float)
        ivs = []
        for e in self.device:
            if self.in_window(e):
                by_name[e["name"]] += e["dur"] / 1e6
                ivs.append((e["ts"], e["ts"] + e["dur"]))
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], self.t0
        for a, b in sorted(ivs):
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            gaps.append((end, self.t1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = [[self.host_at((a + b) / 2), (b - a) / 1e6] for a, b in gaps]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}

    def host_at(self, t: float) -> str:
        """'<outermost benchmark span> / <innermost host event>' at ``t``."""
        cover = [e for e in self.host + self.runtime
                 if e["ts"] <= t <= e["ts"] + e["dur"] and e["name"] != WINDOW]
        if not cover:
            return "host idle"
        inner = min(cover, key=lambda e: e["dur"])
        outer = [e for e in cover if e["name"].startswith("ocr_bench.")]
        lead = max(outer, key=lambda e: e["dur"])["name"] + " / " if outer else ""
        return lead + inner["name"]
