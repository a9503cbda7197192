"""Bilinear grid sampling and affine grids in the JAX package's NHWC
signatures (port of ``lightly_ocr_tpu/ops/grid_sample.py``), on
``F.grid_sample`` and ``F.affine_grid``.

Images are ``[B, H, W, C]``; a grid is ``[B, Hg, Wg, 2]`` with (x, y) in
[-1, 1], torch's convention.  As the JAX function, bilinear sampling
computes in at least float32 (a bfloat16 image gives a float32 result) and
``border`` padding clamps the continuous coordinate before interpolating.
The TPS rectifier (:mod:`lightly_ocr_tpu_torch.models.tps`) samples its
crops with :func:`grid_sample`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(image: torch.Tensor, grid: torch.Tensor, padding_mode: str = "border",
                align_corners: bool = True, mode: str = "bilinear") -> torch.Tensor:
    """Sample ``image`` [B, H, W, C] at ``grid`` [B, Hg, Wg, 2] -> [B, Hg,
    Wg, C].  ``padding_mode`` 'border' (clamp) or 'zeros'; ``mode``
    'bilinear' or 'nearest' (the image's dtype)."""
    if image.ndim != 4 or grid.ndim != 4 or grid.shape[-1] != 2:
        raise ValueError(
            f"expected image [B,H,W,C] and grid [B,Hg,Wg,2]; got "
            f"{tuple(image.shape)} / {tuple(grid.shape)}")
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported mode {mode!r}")
    dt = torch.promote_types(image.dtype, torch.float32)
    out = F.grid_sample(image.permute(0, 3, 1, 2).to(dt), grid.to(dt), mode=mode,
                        padding_mode=padding_mode, align_corners=align_corners)
    out = out.permute(0, 2, 3, 1)
    return out.to(image.dtype) if mode == "nearest" else out


def affine_grid(theta: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``F.affine_grid`` (``align_corners=False``): ``theta`` [B, 2, 3]
    inverse-mapping matrices -> [B, out_h, out_w, 2] grids in [-1, 1] for
    :func:`grid_sample`."""
    theta = theta.to(torch.promote_types(theta.dtype, torch.float32))
    return F.affine_grid(theta, [theta.shape[0], 1, out_h, out_w], align_corners=False)
