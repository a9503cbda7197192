"""Tracing and per-stage timing (port of ``lightly_ocr_tpu/utils/profiling.py``).

* :func:`trace`: a context manager around ``torch.profiler.profile`` with
  the CPU and CUDA activities, writing a Chrome trace (``trace.json``, for
  ``chrome://tracing`` or Perfetto) into ``log_dir``; the CUDA activity is
  asked for where a card is present, and the profiler then records every
  kernel the card ran, the hand kernels by their names (``seam_tail``,
  ``cc_strip``, ``conv12_pool`` ...); ``all_threads`` records the
  operators of every host thread (a mesh's replica threads), not only the
  calling one's;
* :func:`annotate`: a named span (``record_function``) so that pipeline
  stages show on the timeline; it records only while a profiler runs, and
  costs one attribute read otherwise;
* :func:`count` and :func:`counter_values`: named counters, always on, each
  value stamped on ``time.perf_counter`` in a bounded buffer;
* :class:`StageTimer`: named wall-clock totals with a synchronise of the
  device of each result, for per-stage breakdowns.

The program's spans: ``ocr.dispatch`` (one group of ``run_images``),
``ocr.prepare``, ``ocr.detector``, ``ocr.detector.prefix``, ``ocr.boxes``,
``ocr.recognize``, ``crnn.features``, ``crnn.prediction``, ``ocr.decode``,
``ocr.sync`` (one host sync each), ``seam_tail``, ``conv12_pool``;
``loader.wait``, ``loader.batch``, ``loader.decode``, ``loader.collate``,
``train.step``, ``train.forward``, ``train.backward``, ``train.optimizer``,
``train.sync`` (the CRNN's step and ``Trainer.fit``, and the CRAFT step
and ``fit_craft`` of ``train/craft.py``); ``craft.ohem``, ``craft.data``,
``craft.upload`` (``train/craft.py``).  Its counters: ``worker.queue_wait_s``
(one value a request), ``worker.batch_size`` (one a batch),
``ocr.prepare.resize_batch`` (the images of each batched resize of
``BatchedOCR.prepare``) and ``craft.upload_bytes`` (the host bytes of each
CRAFT training step's batch).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict, deque
from typing import Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_FILE = "trace.json"
SYNC = "ocr.sync"  # the span around one host sync
COUNTER_LEN = 1 << 16  # values kept a counter, the newest
_OFF = contextlib.nullcontext()
_counters: dict[str, deque] = {}


@contextlib.contextmanager
def trace(log_dir: str, cuda: bool | None = None,
          all_threads: bool = False) -> Iterator[torch.profiler.profile]:
    """Profile the block and write its Chrome trace to
    ``<log_dir>/trace.json``.  ``cuda`` (default: whether a card is
    present) adds the CUDA activity; asked for without a card, it raises.
    ``all_threads`` records every thread's operators; a PyTorch whose
    profiler cannot raises."""
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig

        if not all_threads_supported():
            raise RuntimeError(f"PyTorch {torch.__version__}'s profiler cannot record other threads")
        kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    if cuda is None:
        cuda = torch.cuda.is_available()
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("a CUDA trace was asked for, and no CUDA device is available")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, **kw) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def all_threads_supported() -> bool:
    """Whether this PyTorch's profiler can record every thread's operators
    (``trace(all_threads=True)``)."""
    from torch._C._profiler import _ExperimentalConfig

    return "profile_all_threads" in (_ExperimentalConfig.__init__.__doc__ or "")


def annotate(name: str):
    """A named span on the profiler's timeline (``record_function``) while
    a profiler runs, on any thread; otherwise a context that does nothing,
    at the cost of one attribute read."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, value: float) -> None:
    """Append ``value`` to the counter ``name``, stamped with
    ``time.perf_counter()``; a counter keeps its newest ``COUNTER_LEN``
    values."""
    values = _counters.get(name)
    if values is None:
        values = _counters.setdefault(name, deque(maxlen=COUNTER_LEN))
    values.append((time.perf_counter(), value))


def counter_values(name: str, since: float = -float("inf"), until: float = float("inf")) -> list:
    """The values of the counter ``name`` stamped in ``[since, until]``
    (``perf_counter`` seconds), oldest first."""
    return [v for t, v in list(_counters.get(name, ())) if since <= t <= until]


def _sync(result) -> None:
    """Wait for the device of every CUDA tensor in ``result`` (a tensor, or
    a tuple / list / dict of them)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _sync(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _sync(v)


class StageTimer:
    """Accumulates wall-clock per named stage; ``sync=True`` waits for the
    device of each result so that the timings hold the device's work."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result_ref: list | None = None):
        """Time the block; ``result_ref[0]``, if given, is synchronised
        before the clock stops."""
        t0 = time.perf_counter()
        yield
        if self.sync and result_ref:
            _sync(result_ref[0])
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def time(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.sync:
            _sync(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:24s} {t*1e3:9.1f} ms total  {t/n*1e3:8.1f} ms/call  x{n}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
