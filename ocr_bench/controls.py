"""The readings the limits of ``correct`` are set from: the program's
checked numbers on many seeds, and the control's (the plain reference in
the program's place, one precision below the configuration's) on some.

    python3 ocr_bench/controls.py --workload serve_attn_bulk --seeds 12 --control-seeds 3 \\
        --seconds 4 --first 1000

Runs on the card, every seed in one process (a short window each, at the
cell's own load), and prints one JSON line a seed and a summary: the
largest and smallest program reading and the smallest control reading of
each number.  With ``--fault <name>`` a fault of ``faults.py`` is planted
in the program first, and the program's readings are the fault's.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ocr_bench import harness  # noqa: E402


def main() -> int:
    harness.set_cache_dirs()
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--first", type=int, default=1000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", help="plant this fault of faults.py in the program first")
    a = p.parse_args()
    import torch

    if a.device == "cuda" and not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    pieces = harness.find_cell(harness.load_json(harness.ROOT / "BENCHMARK.json"), a.workload)
    driver = harness.driver_of(pieces)
    if pieces["config"].get("tf32") is not None:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(pieces["config"]["tf32"])
    if a.fault:
        import pytest

        from ocr_bench import faults

        getattr(faults, a.fault)(pytest.MonkeyPatch())
    prog, low, ctrl = {}, {}, {}
    for i in range(a.seeds):
        seed = a.first + i
        ctx = harness.Ctx(pieces, seed, a.seconds, False, a.device, harness.process_start())
        ctx.control = i < a.control_seeds
        out = driver.run(ctx)
        row = {"seed": seed, "program": out["numbers"], "control": out["control"],
               "complete": out["complete"], "e2e": out["e2e"]}
        print(json.dumps(row), flush=True)
        for k, v in out["numbers"].items():
            if isinstance(v, (int, float)):
                prog[k] = max(prog.get(k, v), v)
                low[k] = min(low.get(k, v), v)
        ctl = out["control"] or {}
        for name, nums in (ctl.items() if "tf32" in ctl else [("control", ctl)]):
            for k, v in nums.items():
                if isinstance(v, (int, float)):
                    ctrl.setdefault(name, {})
                    ctrl[name][k] = min(ctrl[name].get(k, v), v)
        del out
        gc.collect()
        if a.device == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"workload": a.workload, "fault": a.fault, "program_max": prog, "program_min": low,
                      "control_min": ctrl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
