"""Tiny pieces of the serving and training cells for the CPU tests: the
published detector (its widths are fixed) on small receipts, a narrow
recognizer, few clients and short windows."""
from __future__ import annotations

import copy

from ocr_bench import harness


def pieces(cell: str) -> dict:
    """The pieces of ``cell`` from BENCHMARK.json, cut to a CPU's size."""
    p = copy.deepcopy(harness.find_cell(harness.load_json(harness.ROOT / "BENCHMARK.json"), cell))
    p["config"].update(output_channel=32, hidden_size=16)
    t = p["traffic"]
    if t["driver"].startswith("serve"):
        t.update(pool=4, receipt_h=64, receipt_w=48, max_batch=2, warm_batches=[1, 2],
                 sample_dispatches=1, sample_from=1, trace_seconds=1)
        t["clients"] = 4
    else:
        # batch 4 of a narrow recognizer: at Adadelta's lr of 1.0 its changes
        # over three steps depart from the reference's by 4-15% on the CPU
        # (BatchNorms of 2 channels over 4 samples); at 0.01 they stay inside
        # the cell's limits, as the full cell's do at 1.0 on the card
        p["config"].update(batch_size=4, lr=0.01)
        t.update(words=24, trace_seconds=1)
    return p


def ctx(cell: str, seed: int = 5, seconds: float = 2.0, trace: bool = False, p=None):
    p = p or pieces(cell)
    return harness.Ctx(p, seed, seconds, trace, "cpu", harness.process_start()), p
