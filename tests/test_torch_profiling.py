"""The port's profiling utilities: the cases of ``tests/test_profiling.py``.

``StageTimer`` accumulates and reports in the JAX package's line format,
``annotate`` opens a named span, and ``trace`` writes a Chrome trace that
names the spans and the operators run inside it (on the CPU here; on the
card ``chip_smoke.py`` phase ``profile`` checks that it names the hand
kernels).
"""
import json
import os
import threading

import pytest
import torch

from lightly_ocr_tpu_torch.utils.profiling import TRACE_FILE, StageTimer, all_threads_supported, annotate, trace


def test_stage_timer_accumulates():
    t = StageTimer(sync=True)
    out = t.time("matmul", lambda: torch.ones(8, 8) @ torch.ones(8, 8))
    assert out.shape == (8, 8)
    t.time("matmul", lambda: {"y": torch.ones(4, 4) @ torch.ones(4, 4)})
    assert t.counts["matmul"] == 2
    assert t.totals["matmul"] > 0
    rep = t.report()
    assert "matmul" in rep and "ms/call" in rep and rep.endswith("x2")
    t.reset()
    assert t.totals == {}


def test_stage_context_manager():
    t = StageTimer(sync=False)
    with t.stage("outer"):
        _ = torch.zeros(4) + 1
    with t.stage("outer", [torch.zeros(2)]):
        pass
    assert t.counts["outer"] == 2


def test_annotate_runs():
    with annotate("test-span"):
        _ = torch.zeros(2) + 1


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d, cuda=False):
        with annotate("stage-a"):
            _ = torch.ones(16, 16) @ torch.ones(16, 16)
    with open(os.path.join(d, TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "stage-a" in names and "aten::mm" in names


def test_trace_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with trace(str(tmp_path), cuda=True):
            pass


def test_trace_records_every_thread(tmp_path):
    """``all_threads``: the operators of another host thread (a mesh's
    replica) are in the trace, under that thread's id."""
    if not all_threads_supported():
        with pytest.raises(RuntimeError, match="other threads"):
            with trace(str(tmp_path), cuda=False, all_threads=True):
                pass
        return
    d = str(tmp_path / "trace")
    worker = threading.Thread(target=lambda: torch.ones(8, 8) @ torch.ones(8, 8))
    with trace(d, cuda=False, all_threads=True):
        worker.start()
        worker.join()
    with open(os.path.join(d, TRACE_FILE)) as f:
        mm = [e for e in json.load(f)["traceEvents"] if e.get("name") == "aten::mm"]
    assert mm and mm[0]["tid"] != threading.get_ident()
