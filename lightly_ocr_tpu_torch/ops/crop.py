"""Batched ROI crop + resize of the recognizer feed (port of
``lightly_ocr_tpu/ops/crop.py``).

* :func:`crop_resize_normalize_matmul` — the serving feed: two matmuls a
  rect, ``out = Ry^T @ gray @ Cx``, with PIL BICUBIC weights (Keys a =
  -0.5, support widened by the scale on downscales, taps outside the crop
  zeroed and the rest renormalised), batched over images.
* :func:`crop_resize_matmul` — the JAX package's function of one image,
  with 'triangle' (PIL BILINEAR) or 'cubic' weights.
* :func:`crop_resize_batch`, :func:`crop_resize_normalize_batch` — the
  gather form: each output pixel sampled bilinearly at SxS points inside
  its rect (:func:`~lightly_ocr_tpu_torch.ops.grid_sample.grid_sample`)
  and averaged.
"""
from __future__ import annotations

import torch

from lightly_ocr_tpu_torch.ops.grid_sample import grid_sample


def _interp_weights(starts: torch.Tensor, extents: torch.Tensor,
                    src_size: int, out_size: int, kernel: str = "cubic") -> torch.Tensor:
    """[..., src_size, out_size] PIL-style resampling weights for crops
    starting at ``starts`` with ``extents`` pixels (both [...]): 'cubic'
    is PIL BICUBIC, 'triangle' PIL BILINEAR."""
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
    if kernel == "triangle":
        w = torch.clamp(1.0 - at, min=0.0)
    elif kernel == "cubic":
        a = -0.5
        w = torch.where(
            at <= 1.0,
            (a + 2.0) * at**3 - (a + 3.0) * at**2 + 1.0,
            torch.where(at < 2.0, a * at**3 - 5.0 * a * at**2 + 8.0 * a * at - 4.0 * a, 0.0),
        )
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    st = starts[..., None, None]
    inside = (u >= st) & (u <= st + extents[..., None, None] - 1.0 + 1e-6)
    w = torch.where(inside, w, 0.0)
    return w / torch.clamp(w.sum(-2, keepdim=True), min=1e-8)


def _normalize(crops: torch.Tensor) -> torch.Tensor:
    """PIL's saturation, then ``(x / 255 - 0.5) / 0.5``, and a channel."""
    crops = crops.clamp(0.0, 255.0)
    return ((crops / 255.0 - 0.5) / 0.5)[..., None]


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
    return _normalize(crops)


def crop_resize_matmul(image: torch.Tensor, rects: torch.Tensor, out_h: int = 32,
                       out_w: int = 100, kernel: str = "triangle") -> torch.Tensor:
    """image [H, W], rects [K, 4] (row0, col0, row1, col1) -> [K, out_h,
    out_w] float32 crops, each ``Ry^T @ image @ Cx`` with ``kernel``'s
    antialiased weights (:func:`_interp_weights`)."""
    H, W = image.shape
    y0, x0, y1, x1 = rects.float().unbind(-1)
    ry = _interp_weights(y0, torch.clamp(y1 - y0, min=1.0), H, out_h, kernel)  # [K, H, oh]
    cx = _interp_weights(x0, torch.clamp(x1 - x0, min=1.0), W, out_w, kernel)  # [K, W, ow]
    tmp = torch.einsum("kho,hw->kow", ry, image.float())
    return torch.einsum("kow,kwj->koj", tmp, cx)


def crop_resize_batch(image: torch.Tensor, rects: torch.Tensor, out_h: int = 32,
                      out_w: int = 100, supersample: int = 2) -> torch.Tensor:
    """image [H, W], rects [K, 4] -> [K, out_h, out_w] crops: each output
    pixel the mean of ``supersample`` x ``supersample`` bilinear samples at
    PIL's half-pixel centres (``src = (dst + 0.5) * scale - 0.5``), border
    clamped, an approximation of PIL's antialiased downscale."""
    H, W = image.shape
    K = rects.shape[0]
    dev = image.device
    y0, x0, y1, x1 = rects.float().unbind(-1)
    ch = torch.clamp(y1 - y0, min=1.0)
    cw = torch.clamp(x1 - x0, min=1.0)
    s = supersample
    sub = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    oy = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None] + sub  # [oh, s]
    ox = torch.arange(out_w, dtype=torch.float32, device=dev)[:, None] + sub
    sy = y0[:, None, None] + oy * (ch[:, None, None] / out_h) - 0.5
    sx = x0[:, None, None] + ox * (cw[:, None, None] / out_w) - 0.5
    gy = sy.reshape(K, out_h * s, 1).expand(K, out_h * s, out_w * s)
    gx = sx.reshape(K, 1, out_w * s).expand(K, out_h * s, out_w * s)
    grid = torch.stack([gx / max(W - 1.0, 1.0) * 2.0 - 1.0,
                        gy / max(H - 1.0, 1.0) * 2.0 - 1.0], dim=-1)
    src = image.float()[None, :, :, None].expand(K, H, W, 1)
    out = grid_sample(src, grid, padding_mode="border", align_corners=True)
    return out.reshape(K, out_h, s, out_w, s).mean(dim=(2, 4))


def crop_resize_normalize_batch(image: torch.Tensor, rects: torch.Tensor, out_h: int = 32,
                                out_w: int = 100, supersample: int = 2) -> torch.Tensor:
    """:func:`crop_resize_batch`, saturated and scaled to [-1, 1] ->
    [K, out_h, out_w, 1], ready for the CRNN."""
    return _normalize(crop_resize_batch(image, rects, out_h, out_w, supersample))
