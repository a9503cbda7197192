#!/usr/bin/env python3
"""The serving TPS's time on the card, this checkout against another one.

    python3 scripts/torch_tps_serving_ms.py --other build/parent

Times ``Transformation`` (the TPS rectifier) of the ``Config()`` CRNN as
serving runs it (seeded weights, ``to_serving(bfloat16)``, ``eval()``) on
512 crops of 32x100 (a b16 dispatch of 32 boxes), with CUDA events (median
of 50 after 5 warm-up calls), for this checkout and for the port in the
checkout ``--other`` (for instance the parent commit unpacked with ``git
archive`` into ``build/``), each in a process of its own, in the order
this, other, other, this.  Prints one line a run, whether every run gave
the same rectified crops bit for bit, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure() -> None:
    """One run, in the checkout on ``sys.path[0]``: prints ``ms sha``."""
    import torch

    from lightly_ocr_tpu_torch.config import Config
    from lightly_ocr_tpu_torch.models.crnn import CRNNet
    from lightly_ocr_tpu_torch.models.layers import init_module, to_serving

    cfg = Config()
    model = init_module(CRNNet(cfg), torch.Generator().manual_seed(0)).eval()
    model = to_serving(model, "cuda", torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    crops = torch.rand(512, 1, cfg.height, cfg.width, device="cuda", generator=g).mul(2).sub(1).to(torch.bfloat16)
    tps = model.Transformation
    with torch.no_grad():
        for _ in range(5):
            out = tps(crops)
        times = []
        for _ in range(50):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = tps(crops)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
    times.sort()
    sha = hashlib.sha256(out.float().cpu().numpy().tobytes()).hexdigest()[:16]
    print(f"{times[len(times) // 2]:.4f} {sha}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="another checkout of the repo")
    ap.add_argument("--run", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        return measure()
    other = os.path.abspath(args.other)
    runs = []
    for label, root in (("this", ROOT), ("other", other), ("other", other), ("this", ROOT)):
        env = dict(os.environ, PYTHONPATH=root)
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--other", other, "--run"],
                             env=env, cwd=root, check=True, capture_output=True, text=True).stdout.split()
        runs.append((label, float(out[-2]), out[-1]))
        print(f"tps serving {label} ({root}): Transformation {out[-2]} ms on 512 crops of 32x100, bf16 "
              f"(CUDA events, median of 50); output sha256 {out[-1]}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"tps serving: the same rectified crops bit for bit in every run: {len({r[2] for r in runs}) == 1}; "
          f"on {smi}")


if __name__ == "__main__":
    main()
