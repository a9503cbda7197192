#!/usr/bin/env python3
"""Loss curves of the PyTorch port's trainer beside the JAX package's (CPU).

    JAX_PLATFORMS=cpu python scripts/torch_train_curves.py \
        [--prediction Attention] [--transform TPS] [--steps 400] \
        [--output-channel 128] [--hidden 64] [--threads 4]

Both trainers train the same model from the same start on the same batches:
seeded word records drawn with the bitmap "font" of ``chip_smoke.py``
(phase ``train``), the JAX ``Trainer``'s training init carried into the
port's ``Trainer(device="cpu")`` with ``state_dict_from_variables``, and
the two loaders' shared numpy sampler stream.  Adam at 1e-3, batch 64,
32x100, the ``Config()`` layout at the widths given (the full width,
512/256, is for the card).  Prints the mean train loss of each
``--every``-step window for both, the exact-match accuracy of each on
the val records at the end, and one JSON line of all of it.

A witness that the port learns (or plateaus) as the JAX package does:
the curves agree for the first steps (float32 round-off then grows
through the optimizer) and should keep the same shape after.  With
``--perturb 1e-6`` the port starts from a slightly moved init: how far
its curve then drifts from the JAX one is the spread that round-off
alone makes, against which an unperturbed run's gap is read.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def windows(losses: list, every: int) -> list:
    return [float(np.mean(losses[i:i + every])) for i in range(0, len(losses), every)]


def run_jax(cfg, steps: int) -> tuple:
    import jax

    from lightly_ocr_tpu.train.trainer import Trainer, build_loaders

    tr = Trainer(cfg)
    init = jax.tree.map(np.asarray, {"params": tr.state.params, "batch_stats": tr.state.batch_stats})
    train_loader, val_loader = build_loaders(cfg)
    losses, t0 = [], time.perf_counter()
    while len(losses) < steps:
        for images, labels in train_loader:
            tr.state, m = tr.train_step(tr.state, tr.encode_batch(images, labels))
            losses.append(float(m["loss"]))
            if len(losses) == steps:
                break
    wall = time.perf_counter() - t0
    return init, losses, tr.evaluate(val_loader)["accuracy"], wall


def perturbed(init: dict, rel: float, seed: int) -> dict:
    """``init`` with every float leaf times (1 + rel * N(0, 1)) elementwise."""
    import jax

    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda a: (a * (1 + rel * rng.standard_normal(a.shape))).astype(a.dtype)
                        if rel and a.dtype.kind == "f" else a, init)


def run_port(cfg, init: dict, steps: int) -> tuple:
    from lightly_ocr_tpu_torch.config import Config
    from lightly_ocr_tpu_torch.train.trainer import Trainer, build_loaders, encode_batch
    from lightly_ocr_tpu_torch.weights import state_dict_from_variables

    pcfg = Config(**cfg.to_dict())
    tr = Trainer(pcfg, device="cpu")
    tr.model.load_state_dict(state_dict_from_variables(init), strict=True)
    train_loader, val_loader = build_loaders(pcfg)
    losses, t0 = [], time.perf_counter()
    while len(losses) < steps:
        for images, labels in train_loader:
            batch = encode_batch(pcfg, tr.converter, images, labels, tr.device)
            tr.state, m = tr.train_step(tr.state, batch)
            losses.append(m["loss"].item())
            if len(losses) == steps:
                break
    wall = time.perf_counter() - t0
    return losses, tr.evaluate(val_loader)["accuracy"], wall


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--prediction", default="Attention", choices=("Attention", "CTC"))
    p.add_argument("--transform", default="TPS", choices=("TPS", "None"))
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--every", type=int, default=20)
    p.add_argument("--output-channel", type=int, default=128)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--perturb", type=float, default=0.0,
                   help="start the port from the JAX init times (1 + PERTURB * N(0, 1)): a control "
                        "for how far two runs drift apart from round-off alone")
    args = p.parse_args(argv)

    import torch

    torch.set_num_threads(args.threads)
    import chip_smoke
    from lightly_ocr_tpu.config import Config as JConfig

    work = tempfile.mkdtemp(prefix="lightly_ocr_curves_")
    try:
        font = chip_smoke.glyph_font(JConfig().character, args.seed)
        train_root, val_root = os.path.join(work, "train.lor"), os.path.join(work, "val.lor")
        chip_smoke.word_records(train_root, chip_smoke.TRAIN_WORDS, font, chip_smoke.TRAIN_ALPHABET,
                                args.seed)
        chip_smoke.word_records(val_root, chip_smoke.VAL_WORDS, font, chip_smoke.TRAIN_ALPHABET,
                                args.seed + 1)
        cfg = JConfig(prediction=args.prediction, transform=args.transform,
                      output_channel=args.output_channel, hidden_size=args.hidden,
                      batch_size=64, adam=True, lr=1e-3, seeds=args.seed, workers=0,
                      train_root=train_root, val_root=val_root, log_dir=os.path.join(work, "logs"))
        init, jl, jacc, jwall = run_jax(cfg, args.steps)
        pl, pacc, pwall = run_port(cfg.replace(log_dir=os.path.join(work, "plogs")),
                                   perturbed(init, args.perturb, args.seed), args.steps)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    jw, pw = windows(jl, args.every), windows(pl, args.every)
    print(f"{args.transform}-ResNet({args.output_channel})-BiLSTM({args.hidden})-{args.prediction}, "
          f"b64, Adam 1e-3, {args.steps} steps; mean train loss of each {args.every} steps (CPU):")
    for i, (a, b) in enumerate(zip(jw, pw)):
        print(f"  steps {i * args.every + 1:4d}-{(i + 1) * args.every:4d}: JAX {a:.4f}  port {b:.4f}")
    print(f"first step: JAX {jl[0]:.6f}, port {pl[0]:.6f}; val accuracy: JAX {jacc:.3f}, port {pacc:.3f}; "
          f"wall: JAX {jwall:.1f} s, port {pwall:.1f} s")
    print(json.dumps({"config": vars(args), "jax": jw, "port": pw, "jax_first": jl[0], "port_first": pl[0],
                      "jax_val_acc": jacc, "port_val_acc": pacc}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
