#!/usr/bin/env python3
"""Controls for the card-against-CPU training gates (run on the card).

    python3 scripts/torch_train_gate_controls.py

``chip_smoke.py`` phase ``train`` (a) and ``tests/test_torch_train_cuda.py``
hold one training step on the card to the CPU: float32 within max(1e-3,
4x the CPU float32's own distance from float64), float64 within 1e-8
(1e-3 in the TPS rectifier).  This script shows that those gates fail a
wrong card step.  It runs both under each control, on the card only:

* ``sound``: the step as shipped (TF32 off); every gate must pass;
* ``tf32``: TF32 on for matmuls and convolutions (the lower precision the
  port rules out for training);
* ``bn_unbiased``: training BatchNorm normalising with the unbiased batch
  variance (``n / (n - 1)`` times the biased one);
* ``backbone_grad_1pct``: the gradient that leaves the ResNet backbone's
  output scaled by 1.01 (the backbone's and the rectifier's gradients 1%
  off, the heads' exact).

Each fault must fail at least one gate of phase (a) for both heads, and the
cuda test for both of its cases.  Prints each run's readings and failed
gates, the card's name and power limit, and exits 1 if a control does not
behave as expected.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import chip_smoke  # noqa: E402
import test_torch_train_cuda  # noqa: E402
from lightly_ocr_tpu_torch.models.layers import BatchNorm2d  # noqa: E402
from lightly_ocr_tpu_torch.models.resnet import ResNet50v2  # noqa: E402


@contextlib.contextmanager
def tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@contextlib.contextmanager
def patched(cls, forward):
    orig = cls.forward
    cls.forward = lambda self, x: forward(orig, self, x) if x.is_cuda else orig(self, x)
    try:
        yield
    finally:
        cls.forward = orig


def bn_unbiased(orig, self, x):
    if not self.training:
        return orig(self, x)
    dt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dt)
    mean = xf.mean((0, 2, 3), keepdim=True)
    var = xf.var((0, 2, 3), unbiased=True, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + self.eps)
    return (y * self.weight.to(dt)[:, None, None] + self.bias.to(dt)[:, None, None]).to(x.dtype)


def backbone_grad(orig, self, x):
    out = orig(self, x)
    if out.requires_grad:
        out.register_hook(lambda g: g * 1.01)
    return out


CONTROLS = {
    "sound": contextlib.nullcontext,
    "tf32": tf32,
    "bn_unbiased": lambda: patched(BatchNorm2d, bn_unbiased),
    "backbone_grad_1pct": lambda: patched(ResNet50v2, backbone_grad),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    from lightly_ocr_tpu_torch.config import Config
    from lightly_ocr_tpu_torch.data.loader import align_collate
    from lightly_ocr_tpu_torch.data.records import RecordDataset

    cfg = Config().replace(adam=True, lr=1e-3)
    work = tempfile.mkdtemp(prefix="lightly_ocr_controls_")
    try:
        root = os.path.join(work, "train.lor")
        chip_smoke.word_records(root, chip_smoke.TRAIN_BATCH, chip_smoke.glyph_font(cfg.character, chip_smoke.SEED),
                                chip_smoke.TRAIN_ALPHABET, chip_smoke.SEED)
        ds = RecordDataset(root, character=cfg.character, batch_max_len=cfg.batch_max_len)
        images, labels = align_collate([ds[i] for i in range(chip_smoke.TRAIN_BATCH)], keep_ratio=True)
        ds.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    unexpected = []
    for control, ctx in CONTROLS.items():
        for head in ("Attention", "CTC"):
            with ctx():
                runs = chip_smoke.train_grads(cfg.replace(prediction=head), images, labels, "cuda")
            line, failed = chip_smoke.train_gates(runs)
            print(f"control {control}: phase train (a) {head} b{len(labels)}: failed {failed}; {line}",
                  flush=True)
            if bool(failed) != (control != "sound"):
                unexpected.append(f"phase (a) {control} {head}")
        for prediction, transform in (("CTC", "None"), ("Attention", "TPS")):
            msg = ""
            try:
                with ctx():
                    test_torch_train_cuda.test_train_step_card_equals_cpu(
                        torch.device("cuda"), prediction, transform)
            except AssertionError as e:
                msg = str(e)[:300].replace("\n", " ") or "AssertionError"
            print(f"control {control}: cuda test {prediction}-{transform}: "
                  f"{'failed: ' + msg if msg else 'passed'}", flush=True)
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            if bool(msg) != (control != "sound"):
                unexpected.append(f"cuda test {control} {prediction}-{transform}")
    print(f"on {smi}")
    print(f"unexpected: {unexpected}" if unexpected else "every control behaved as expected")
    return 1 if unexpected else 0


if __name__ == "__main__":
    sys.exit(main())
