"""The recognizer's training input from a word image, as the published
data pipeline makes it (deep-text-recognition-benchmark ``AlignCollate``
with ``PAD``/keep-ratio): resized with PIL's ``BICUBIC`` to the target
height at the word's aspect (width at most the target's), each resampling
pass rounded to 8 bits as PIL does for an ``L`` image, right-padded by
repeating the last column, then ``(x / 255 - 0.5) / 0.5``.  Written in
float64 NumPy from PIL's description (Keys' cubic, a = -0.5, the support
widened by the scale on a downscale, the weights of a window normalised)."""
from __future__ import annotations

import math

import numpy as np


def _cubic(t: np.ndarray) -> np.ndarray:
    a = -0.5
    t = np.abs(t)
    return np.where(t < 1, ((a + 2) * t - (a + 3)) * t * t + 1,
                    np.where(t < 2, (((t - 5) * t + 8) * t - 4) * a, 0.0))


def _pass(img: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    n_in = img.shape[axis]
    scale = n_in / n_out
    fs = max(scale, 1.0)
    center = (np.arange(n_out) + 0.5) * scale
    w = _cubic((np.arange(n_in)[None, :] + 0.5 - center[:, None]) / fs)
    w /= w.sum(1, keepdims=True)
    out = np.tensordot(w, np.moveaxis(img.astype(np.float64), axis, 0), axes=(1, 0))
    return np.moveaxis(np.clip(np.floor(out + 0.5), 0, 255), 0, axis)


def keep_ratio_image(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 gray [h, w] -> float32 [height, width] in [-1, 1]."""
    h, w = img.shape
    rw = max(min(math.ceil(height * w / max(h, 1)), width), 1)
    x = img.astype(np.float64)
    if w != rw:
        x = _pass(x, rw, 1)
    if h != height:
        x = _pass(x, height, 0)
    out = np.empty((height, width))
    out[:, :rw] = x
    out[:, rw:] = x[:, rw - 1:rw]
    return ((out / 255.0 - 0.5) / 0.5).astype(np.float32)
