"""Model export: ``torch.export`` programs (port of ``lightly_ocr_tpu/export.py``).

Counterpart of the reference's ONNX export (``ocr/torch2onnx.py``), which
was blocked by ``grid_sample`` having no ONNX op (``torch2onnx.py:22``),
and of the JAX package's StableHLO export.  ``torch.export`` traces the
whole recognizer (TPS with ``F.grid_sample``, the ResNet, the BiLSTMs and
the greedy attention loop, unrolled over its fixed number of steps) into
one ``ExportedProgram`` that ``torch.export.load`` restores and runs
without the port's model code.  The detector is exported as the plain
:class:`~lightly_ocr_tpu_torch.models.vgg_unet.VGG_UNet`, as the JAX
package exports the plain flax module: the hand kernels of the serving
plans are not in either artifact.

CLI:  python -m lightly_ocr_tpu_torch.export CRNN converted_models/crnn.pt2
"""
from __future__ import annotations

import argparse
import os
from typing import Sequence

import torch

from lightly_ocr_tpu_torch.config import Config, load_config
from lightly_ocr_tpu_torch.serving.batch import resolve_device


def _prepare(model: torch.nn.Module, state_dict, seed: int, device) -> torch.nn.Module:
    from lightly_ocr_tpu_torch.models.layers import init_train_params

    if state_dict is None:
        init_train_params(model, torch.Generator().manual_seed(int(seed)))
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.to(resolve_device(device)).eval()


def export_crnn(cfg: Config | None = None, state_dict: dict | None = None, batch: int = 1,
                seed: int = 0, device="cuda"):
    """-> (``torch.export.ExportedProgram``, example_inputs) for the
    recognizer in ``eval()`` (the greedy decode for the attention head):
    ``images [batch, height, width, C]`` zeros in, the logits out.  Without
    ``state_dict`` the weights are the seeded training initialisation."""
    from lightly_ocr_tpu_torch.models.crnn import CRNNet

    cfg = cfg or Config()
    model = _prepare(CRNNet(cfg), state_dict, seed, device)
    dev = next(model.parameters()).device
    images = torch.zeros((batch, cfg.height, cfg.width, cfg.derived_input_channel), device=dev)
    with torch.no_grad():
        return torch.export.export(model, (images,)), (images,)


def export_craft(cfg: Config | None = None, state_dict: dict | None = None, batch: int = 1,
                 height: int = 256, width: int = 256, seed: int = 0, device="cuda"):
    """-> (``torch.export.ExportedProgram``, example_inputs) for the plain
    detector in ``eval()``: ``images [batch, height, width, 3]`` zeros in,
    its ``(scores, feature)`` out."""
    from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet

    model = _prepare(VGG_UNet(), state_dict, seed, device)
    dev = next(model.parameters()).device
    images = torch.zeros((batch, height, width, 3), device=dev)
    with torch.no_grad():
        return torch.export.export(model, (images,)), (images,)


def save_exported(exported, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(exported, path)


def load_exported(path: str):
    return torch.export.load(path)


def main(argv: Sequence[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="export models with torch.export")
    p.add_argument("model", choices=["CRAFT", "CRNN"])
    p.add_argument("out", help="output .pt2 path")
    p.add_argument("--config", default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the CPU only when asked)")
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    if args.model == "CRNN":
        exported, example = export_crnn(cfg, batch=args.batch, device=args.device)
    else:
        exported, example = export_craft(cfg, batch=args.batch, height=args.height,
                                         width=args.width, device=args.device)
    save_exported(exported, args.out)
    # round-trip smoke check
    restored = load_exported(args.out)
    with torch.no_grad():
        out = restored.module()(*example)
    out = out[0] if isinstance(out, (tuple, list)) else out
    print(f"exported {args.model} -> {args.out} "
          f"({os.path.getsize(args.out)} bytes), output {tuple(out.shape)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
