"""Batched ROI crop + resize of the recognizer feed (two matmuls per image).

Port of ``lightly_ocr_tpu/ops/crop.py::crop_resize_normalize_matmul`` with
the cubic ``_interp_weights`` (PIL BICUBIC, Keys a = -0.5, support widened
by the scale on downscales, taps outside the crop zeroed and the rest
renormalised), batched over images: ``out = Ry^T @ gray @ Cx`` per rect.
"""
from __future__ import annotations

import torch


def _interp_weights(starts: torch.Tensor, extents: torch.Tensor,
                    src_size: int, out_size: int) -> torch.Tensor:
    """[..., src_size, out_size] PIL-bicubic resampling weights for crops
    starting at ``starts`` with ``extents`` pixels (both [...])."""
    dev = starts.device
    scale = extents / out_size
    s = torch.clamp(scale, min=1.0)[..., None, None]
    centers = (
        starts[..., None, None]
        + (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5)
        * scale[..., None, None]
        - 0.5
    )  # [..., 1, out]
    u = torch.arange(src_size, dtype=torch.float32, device=dev)[:, None]
    at = ((u - centers) / s).abs()
    a = -0.5
    w = torch.where(
        at <= 1.0,
        (a + 2.0) * at**3 - (a + 3.0) * at**2 + 1.0,
        torch.where(at < 2.0, a * at**3 - 5.0 * a * at**2 + 8.0 * a * at - 4.0 * a, 0.0),
    )
    st = starts[..., None, None]
    inside = (u >= st) & (u <= st + extents[..., None, None] - 1.0 + 1e-6)
    w = torch.where(inside, w, 0.0)
    return w / torch.clamp(w.sum(-2, keepdim=True), min=1e-8)


def crop_resize_normalize_matmul(gray: torch.Tensor, rects: torch.Tensor,
                                 out_h: int = 32, out_w: int = 100) -> torch.Tensor:
    """gray [B, H, W] in [0, 255], rects [B, M, 4] (row0, col0, row1, col1)
    -> [B, M, out_h, out_w, 1] crops in [-1, 1] (PIL saturation, then
    ``(x / 255 - 0.5) / 0.5``)."""
    B, H, W = gray.shape
    rects = rects.float()
    y0, x0, y1, x1 = rects.unbind(-1)
    ry = _interp_weights(y0, torch.clamp(y1 - y0, min=1.0), H, out_h)  # [B, M, H, oh]
    cx = _interp_weights(x0, torch.clamp(x1 - x0, min=1.0), W, out_w)  # [B, M, W, ow]
    tmp = torch.einsum("bmho,bhw->bmow", ry, gray.float())
    crops = torch.einsum("bmow,bmwj->bmoj", tmp, cx)
    crops = crops.clamp(0.0, 255.0)
    return ((crops / 255.0 - 0.5) / 0.5)[..., None]
