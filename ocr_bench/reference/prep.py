"""Plain image preparation of the serving reference.

* The detector's canvas: CRAFT-pytorch's ``resize_aspect_ratio`` (the long
  side to ``min(mag_ratio * long side, canvas_size)``, bilinear with
  half-pixel centres and no antialias, as cv2's ``INTER_LINEAR``), pasted
  top-left on a zero canvas whose sides round up to 32 and then to the
  serving system's shape bucket, then ImageNet's mean and variance
  (``normalizeMeanVariance``).
* The recognizer's gray image: ITU-R 601 luma in float (PIL's ``L``
  weights; PIL rounds to 8 bits, the system does not).
* A word crop: ``Image.crop(rect).resize((100, 32), BICUBIC)`` in float
  arithmetic (Keys' cubic, a = -0.5, support widened by the scale on a
  downscale, the window clipped to the crop and renormalised; PIL rounds
  each pass to 8 bits, the system does not), saturated to [0, 255], then
  ``(x / 255 - 0.5) / 0.5``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
VAR = (0.229, 0.224, 0.225)
LUMA = (0.299, 0.587, 0.114)


def _ceil(x: float, q: int) -> int:
    return int(math.ceil(x / q) * q)


def canvas_plan(h: int, w: int, canvas_size: int, mag_ratio: float, granularity: int):
    """(target_h, target_w, canvas_h, canvas_w, ratio) of an h x w image."""
    target = min(mag_ratio * max(h, w), float(canvas_size))
    ratio = target / max(h, w)
    th, tw = int(h * ratio), int(w * ratio)
    cap = _ceil(canvas_size, 32)
    ch = min(_ceil(_ceil(th, 32), granularity), cap)
    cw = min(_ceil(_ceil(tw, 32), granularity), cap)
    if th > ch or tw > cw:
        ratio *= min(ch / th, cw / tw)
        th, tw = int(h * ratio), int(w * ratio)
    return th, tw, ch, cw, ratio


def detector_canvas(img: np.ndarray, cfg: dict, device) -> tuple[torch.Tensor, float]:
    """uint8 RGB [h, w, 3] -> ([canvas_h, canvas_w, 3] normalized float32,
    the resize ratio)."""
    h, w = img.shape[:2]
    th, tw, ch, cw, ratio = canvas_plan(h, w, cfg["canvas_size"], cfg["magnify_ratio"],
                                        cfg["bucket_granularity"])
    x = torch.as_tensor(img, device=device).float().permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(th, tw), mode="bilinear", align_corners=False, antialias=False)
    canvas = torch.zeros((ch, cw, 3), device=device)
    canvas[:th, :tw] = x[0].permute(1, 2, 0)
    mean = torch.tensor(MEAN, device=device) * 255.0
    var = torch.tensor(VAR, device=device) * 255.0
    return (canvas - mean) / var, ratio


def gray(img: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(img, device=device).float() @ torch.tensor(LUMA, device=device)


def _bicubic(t: torch.Tensor) -> torch.Tensor:
    a = -0.5
    t = t.abs()
    near = ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0
    far = (((t - 5.0) * t + 8.0) * t - 4.0) * a
    return torch.where(t < 1.0, near, torch.where(t < 2.0, far, torch.zeros_like(t)))


def _resample_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] weights of one bicubic pass."""
    scale = n_in / n_out
    fs = max(scale, 1.0)
    center = (torch.arange(n_out, device=device, dtype=torch.float64) + 0.5) * scale
    src = torch.arange(n_in, device=device, dtype=torch.float64) + 0.5
    w = _bicubic((src[None, :] - center[:, None]) / fs)
    return (w / w.sum(1, keepdim=True)).float()


def crop(gray_img: torch.Tensor, rect, out_h: int, out_w: int) -> torch.Tensor:
    """gray [H, W], rect (r0, c0, r1, c1) -> [out_h, out_w, 1] in [-1, 1]."""
    r0, c0, r1, c1 = (int(v) for v in rect)
    region = gray_img[r0:r1, c0:c1]
    dev = gray_img.device
    y = _resample_matrix(region.shape[0], out_h, dev) @ region @ _resample_matrix(region.shape[1], out_w, dev).T
    return ((y.clamp(0.0, 255.0) / 255.0 - 0.5) / 0.5)[..., None]
