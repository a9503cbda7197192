"""Connected-component labelling of the detector's foreground masks.

Port of ``lightly_ocr_tpu/ops/pallas_cc.py`` (the Pallas ``_cc_kernel``
behind ``label_components_pallas``/``label_components_checked``) and of the
XLA reference ``lightly_ocr_tpu/ops/detection.py::label_components``.
Semantics of both: 4-connectivity, each foreground pixel's label is the
minimum linear index (``r * W + c``) of its component, background is
``H * W``.

:func:`label_components` is the kernel's wrapper: a CPU tensor takes the
plain version :func:`label_components_plain`, a CUDA tensor launches the
union-find kernel of ``csrc/cc.cu`` or raises.  Both are exact for every
mask, so the port needs no convergence check and no escalation; the check
itself, :func:`labels_converged`, is kept for the tests.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from lightly_ocr_tpu_torch.ops import native


def label_components_plain(fg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``[B, H, W]`` (or ``[H, W]``) bool -> int32.

    Min-label hooking with full pointer jumping over the pixel graph's
    edges: every round links each edge's larger root under the smaller
    (``scatter_reduce`` amin) and then jumps every pointer to its root.  A
    parent is always a smaller index of the same component, so a
    component's minimum index stays a root; the loop ends when every edge
    joins equal roots, i.e. when every pixel points at its component's
    minimum.  The root count falls every round, so it terminates."""
    if fg.ndim == 2:
        return label_components_plain(fg[None])[0]
    B, H, W = fg.shape
    HW = H * W
    fg = fg.bool()
    idx = torch.arange(B * HW, device=fg.device).view(B, H, W)
    right = fg[:, :, :-1] & fg[:, :, 1:]
    down = fg[:, :-1, :] & fg[:, 1:, :]
    u = torch.cat([idx[:, :, :-1][right], idx[:, :-1, :][down]])
    v = torch.cat([idx[:, :, 1:][right], idx[:, 1:, :][down]])
    p = idx.reshape(-1).clone()
    while True:
        pu, pv = p[u], p[v]
        if torch.equal(pu, pv):
            break
        m = torch.minimum(pu, pv)
        p.scatter_reduce_(0, pu, m, "amin")
        p.scatter_reduce_(0, pv, m, "amin")
        while True:
            pp = p[p]
            if torch.equal(pp, p):
                break
            p = pp
    base = (torch.arange(B, device=fg.device) * HW).view(B, 1, 1)
    labels = p.view(B, H, W) - base
    return torch.where(fg, labels, HW).to(torch.int32)


_SIG = {"cc_launch": [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
        + [ctypes.c_void_p]}


def label_components(fg: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: ``[B, H, W]`` (or ``[H, W]``) bool -> int32 labels
    (min linear index per component, background ``H * W``)."""
    if fg.device.type == "cpu":
        return label_components_plain(fg)
    if fg.device.type != "cuda":
        raise ValueError(f"label_components: unsupported device {fg.device}")
    if fg.ndim == 2:
        return label_components(fg[None])[0]
    if fg.ndim != 3 or fg.dtype != torch.bool or not fg.is_contiguous():
        raise ValueError(f"label_components: fg must be contiguous bool [B, H, W], got {fg.dtype} {tuple(fg.shape)}")
    B, H, W = fg.shape
    if H * W >= 2**31 or B * H * W == 0:
        raise ValueError(f"label_components: unsupported shape {tuple(fg.shape)}")
    lib = native.load("cc", _SIG)
    labels = torch.empty((B, H, W), dtype=torch.int32, device=fg.device)
    err = lib.cc_launch(native.ptr(fg), native.ptr(labels), B, H, W,
                        native.stream(fg.device))
    native.check(err, "label_components")
    label_components.launches += 1
    return labels


label_components.launches = 0


def labels_converged(fg: torch.Tensor, labels: torch.Tensor) -> bool:
    """True iff no two 4-adjacent foreground pixels carry different labels
    (``pallas_cc.py::labels_converged``)."""
    diff_r = fg[..., :, :-1] & fg[..., :, 1:] & (labels[..., :, :-1] != labels[..., :, 1:])
    diff_d = fg[..., :-1, :] & fg[..., 1:, :] & (labels[..., :-1, :] != labels[..., 1:, :])
    return not bool(diff_r.any() or diff_d.any())


def spiral_mask(H: int, W: int, pitch: int = 8) -> np.ndarray:
    """One connected rectangular spiral, ``[H, W]`` bool: the minimum label
    has to travel the whole winding length (the recipe of the JAX
    package's ``tests/test_pallas_cc.py``).  Shared by the tests and
    ``chip_smoke.py`` so the CPU and the card check the same mask."""
    mask = np.zeros((H, W), bool)
    top, left, bottom, right = 2, 2, H - 3, W - 3
    while top < bottom and left < right:
        mask[top, left:right + 1] = True
        mask[top:bottom + 1, right] = True
        mask[bottom, left + pitch:right + 1] = True
        mask[top + pitch:bottom + 1, left + pitch] = True
        top += pitch
        left += pitch
        bottom -= pitch
        right -= pitch
    return mask


def comb_mask(H: int, W: int, spacing: int = 6) -> np.ndarray:
    """One connected serpentine comb, ``[H, W]`` bool: vertical teeth joined
    alternately at the top and the bottom (same source as
    :func:`spiral_mask`)."""
    mask = np.zeros((H, W), bool)
    prev = None
    for i, c in enumerate(range(2, W - 2, spacing)):
        mask[2:H - 2, c] = True
        if prev is not None:
            mask[2 if i % 2 == 0 else H - 3, prev:c + 1] = True
        prev = c
    return mask
