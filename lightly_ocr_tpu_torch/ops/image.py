"""Detector input preparation (port of ``lightly_ocr_tpu/ops/image.py``).

* ``plan_aspect_resize`` / ``pick_canvas_bucket`` / ``pick_gray_bucket`` —
  host-side geometry of the reference ``resizeAspectRatio``
  (``ocr/tools/imgproc.py:38-65``) with coarse canvas and gray buckets, so
  distinct receipt sizes share batch shapes.
* ``make_detector_input`` — bilinear resize (half-pixel centres, no
  antialias: ``F.interpolate(align_corners=False, antialias=False)``), paste
  top-left onto a zero canvas, ImageNet normalisation
  (``imgproc.py:19-35``).
* ``resize_bilinear`` — that resize alone (cv2's ``INTER_LINEAR``);
  ``denormalize_mean_variance`` — the normalisation's inverse, clipped.
* ``rgb_to_gray`` — luma with PIL's ``L`` weights.
* ``resize_normalize`` — the recognizer feed of one whole crop: PIL
  bicubic with antialias, saturated, scaled to [-1, 1]
  (``dataset.py:43-47``), as the matmul crop of :mod:`.crop` computes it.
* ``adjust_box_coordinates`` — score-map box corners to image space.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from lightly_ocr_tpu_torch.ops.crop import crop_resize_normalize_matmul
from lightly_ocr_tpu_torch.utils.profiling import SYNC, annotate

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_VAR = (0.229, 0.224, 0.225)
LUMA = (0.299, 0.587, 0.114)  # ITU-R 601-2, PIL's "L" conversion


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``IMAGENET_MEAN``, ``IMAGENET_VAR`` and ``LUMA`` as float32 tensors
    on ``device``, uploaded once a device: an upload from pageable memory
    waits for the card's queued work.  Callers must not write to them."""
    with annotate(SYNC):
        return tuple(torch.tensor(c, dtype=torch.float32, device=device)
                     for c in (IMAGENET_MEAN, IMAGENET_VAR, LUMA))


def normalize_mean_variance(img: torch.Tensor) -> torch.Tensor:
    """[..., 3] uint8-range RGB -> normalized float32."""
    mean, var, _ = _constants(img.device)
    return (img.float() - mean * 255.0) / (var * 255.0)


def denormalize_mean_variance(img: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`normalize_mean_variance`, clipped to [0, 255]."""
    mean, var, _ = _constants(img.device)
    return ((img.float() * var + mean) * 255.0).clamp(0.0, 255.0)


class ResizePlan(NamedTuple):
    target_h: int  # image content size after aspect-preserving resize
    target_w: int
    canvas_h: int  # padded canvas
    canvas_w: int
    ratio: float  # content / original scale factor
    heatmap_h: int  # detector score-map size (canvas / 2)
    heatmap_w: int


def plan_aspect_resize(
    height: int,
    width: int,
    square_size: int = 1280,
    mag_ratio: float = 1.5,
    canvas_bucket: tuple[int, int] | None = None,
) -> ResizePlan:
    """Resize/pad geometry of ``resizeAspectRatio``; a ``canvas_bucket``
    pins the canvas and caps the content to fit it."""
    target_size = min(mag_ratio * max(height, width), float(square_size))
    ratio = target_size / max(height, width)
    target_h, target_w = int(height * ratio), int(width * ratio)
    if canvas_bucket is None:
        canvas_h = _ceil_to(target_h, 32)
        canvas_w = _ceil_to(target_w, 32)
    else:
        canvas_h, canvas_w = canvas_bucket
        if target_h > canvas_h or target_w > canvas_w:
            shrink = min(canvas_h / target_h, canvas_w / target_w)
            ratio *= shrink
            target_h, target_w = int(height * ratio), int(width * ratio)
    return ResizePlan(target_h, target_w, canvas_h, canvas_w, ratio,
                      canvas_h // 2, canvas_w // 2)


def _ceil_to(x: int, q: int) -> int:
    return x if x % q == 0 else x + (q - x % q)


def pick_canvas_bucket(
    height: int,
    width: int,
    square_size: int = 1280,
    mag_ratio: float = 1.5,
    granularity: int = 256,
) -> tuple[int, int]:
    """The reference canvas rounded up to a multiple of ``granularity``,
    capped at the square size rounded up to 32."""
    plan = plan_aspect_resize(height, width, square_size, mag_ratio)
    rh = int(math.ceil(plan.canvas_h / granularity) * granularity)
    rw = int(math.ceil(plan.canvas_w / granularity) * granularity)
    cap = int(math.ceil(square_size / 32) * 32)
    return (min(rh, cap), min(rw, cap))


def pick_gray_bucket(
    height: int, width: int, granularity: int = 256
) -> tuple[int, int]:
    """An ORIGINAL-resolution extent rounded up to a coarse bucket."""
    return (
        int(math.ceil(max(height, 1) / granularity) * granularity),
        int(math.ceil(max(width, 1) / granularity) * granularity),
    )


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[H, W, C] or [B, H, W, C] -> float32 at (out_h, out_w): bilinear with
    half-pixel centres and no antialias (cv2's ``INTER_LINEAR``, the JAX
    package's ``jax.image.resize(..., antialias=False)``)."""
    x = img.float()
    x = (x if x.ndim == 4 else x[None]).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False,
                      antialias=False).permute(0, 2, 3, 1)
    return y if img.ndim == 4 else y[0]


def make_detector_input(img: torch.Tensor, plan: ResizePlan) -> torch.Tensor:
    """[H, W, 3] RGB -> [canvas_h, canvas_w, 3] normalized canvas."""
    content = resize_bilinear(img, plan.target_h, plan.target_w)
    canvas = torch.zeros(
        (plan.canvas_h, plan.canvas_w, 3), dtype=torch.float32,
        device=img.device,
    )
    canvas[: plan.target_h, : plan.target_w] = content
    return normalize_mean_variance(canvas)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB -> [...] float32 luma (PIL ``L`` weights)."""
    return img.float() @ _constants(img.device)[2]


def resize_normalize(crops: torch.Tensor, height: int = 32, width: int = 100) -> torch.Tensor:
    """[B, H, W] or [B, H, W, 1] gray crops in [0, 255] -> [B, height,
    width, 1] in [-1, 1]: each whole crop through the matmul crop's PIL
    bicubic weights (antialiased on downscales), saturated to [0, 255], then
    ``(x / 255 - 0.5) / 0.5``."""
    if crops.ndim == 4:
        crops = crops[..., 0]
    B, H, W = crops.shape
    whole = torch.tensor([0.0, 0.0, H, W], device=crops.device).expand(B, 1, 4)
    return crop_resize_normalize_matmul(crops.float(), whole, height, width)[:, 0]


def adjust_box_coordinates(boxes, ratio_w: float, ratio_h: float,
                           ratio_net: float = 2.0) -> torch.Tensor:
    """Scale heatmap-space box corners ``[..., 2]`` (x, y) back to the
    original image's space (``det_utils.py:259-265``; ``ratio_net`` 2 is
    the detector's half resolution)."""
    boxes = torch.as_tensor(boxes)
    scale = torch.tensor([ratio_w * ratio_net, ratio_h * ratio_net], dtype=torch.float32,
                         device=boxes.device)
    return boxes * scale
