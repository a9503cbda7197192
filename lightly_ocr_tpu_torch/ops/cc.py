"""Connected-component labelling of the detector's foreground masks.

Port of ``lightly_ocr_tpu/ops/pallas_cc.py`` (the Pallas ``_cc_kernel``
behind ``label_components_pallas``/``label_components_checked``) and of the
XLA reference ``lightly_ocr_tpu/ops/detection.py::label_components``.
Semantics of both: 4-connectivity, each foreground pixel's label is the
minimum linear index (``r * W + c``) of its component, background is
``H * W``.

:func:`label_components` is the kernel's wrapper: a CPU tensor takes the
plain version :func:`label_components_plain`, a CUDA tensor launches
``csrc/cc.cu`` or raises.  The kernel is three launches: union-find on each
strip of :func:`strip_rows` full-width rows in shared memory
(``cc_strip``), the unions across the seams between strips in the label
map (``cc_seams``), and a flatten of each label to its root
(``cc_flatten``).  Its geometry is mirrored here (:func:`geometry`, held
against the library's ``cc_geometry`` by :func:`kernel_geometry`).  Both
versions are exact for every mask, so the port needs no convergence check
and no escalation; the check itself, :func:`labels_converged`, is kept for
the tests.
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


# csrc/cc.cu's geometry (cc_geometry reports the compiled values)
STRIP_THREADS = 512  # threads of a cc_strip block
STRIP_PIXELS = 4096  # pixels of a strip, about: rows = this // W
SMEM_BUDGET = 115712  # shared bytes of a strip block, at most: two blocks an SM
PHASES = ("strip", "seams", "flatten")  # the kernel's launches, in order


def strip_smem(rows: int, W: int) -> int:
    """Shared bytes of a strip: a foreground word per 32-column row
    segment, the mask bytes at their address's offset mod 16 (each part
    rounded up to 16), then two int32 arrays (the parents and the roots of
    the runs)."""
    def a16(x):
        return (x + 15) // 16 * 16
    return a16(4 * rows * -(-W // 32)) + a16(rows * W + 15) + 8 * rows * W


def strip_rows(W: int) -> int:
    """Rows of a ``cc_strip`` block for maps ``W`` wide: about
    :data:`STRIP_PIXELS` pixels, at least one row; 0 when one row does not
    fit the shared-memory budget."""
    if W <= 0:
        return 0
    R = STRIP_PIXELS // W if W < STRIP_PIXELS // 2 else 1
    return R if strip_smem(R, W) <= SMEM_BUDGET else 0


def geometry(W: int) -> tuple[int, ...]:
    """The wrapper's copy of ``cc_geometry(W)``: (rows, shared bytes,
    threads, pixels a strip, budget)."""
    R = strip_rows(W)
    return (R, strip_smem(R, W) if R else 0, STRIP_THREADS, STRIP_PIXELS, SMEM_BUDGET)


_SIG = {"cc_launch": [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
        + [ctypes.c_void_p],
        "cc_phases": [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
        + [ctypes.c_void_p],
        "cc_geometry": [ctypes.c_int, ctypes.c_void_p]}


def kernel_geometry(W: int) -> tuple[int, ...]:
    """``cc_geometry(W)`` as compiled into the CUDA library (builds it on
    first use; needs ``nvcc``)."""
    g = (ctypes.c_int * 5)()
    native.load("cc", _SIG).cc_geometry(W, g)
    return tuple(g)


def _checked(fg: torch.Tensor) -> tuple[int, int, int]:
    if fg.device.type != "cuda":
        raise ValueError(f"label_components: unsupported device {fg.device}")
    if fg.ndim != 3 or fg.dtype != torch.bool or not fg.is_contiguous():
        raise ValueError(f"label_components: fg must be contiguous bool [B, H, W], got {fg.dtype} {tuple(fg.shape)}")
    B, H, W = fg.shape
    if H * W >= 2**31 or B * H * W == 0 or strip_rows(W) == 0:
        raise ValueError(f"label_components: unsupported shape {tuple(fg.shape)}")
    return B, H, W


def label_components(fg: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: ``[B, H, W]`` (or ``[H, W]``) bool -> int32 labels
    (min linear index per component, background ``H * W``)."""
    if fg.device.type == "cpu":
        return label_components_plain(fg)
    if fg.ndim == 2:
        return label_components(fg[None])[0]
    B, H, W = _checked(fg)
    lib = native.load("cc", _SIG)
    labels = torch.empty((B, H, W), dtype=torch.int32, device=fg.device)
    err = lib.cc_launch(native.ptr(fg), native.ptr(labels), B, H, W,
                        native.stream(fg.device))
    native.check(err, "label_components")
    native.count_launch(label_components)
    return labels


label_components.launches = 0


def phase_prefixes(fg: torch.Tensor) -> list:
    """``[(phase, run)]`` for timing the kernel's launches: ``run()`` makes
    the first launches up to that phase into a fresh label map and returns
    it, so the split is the differences of their times.  Not counted as
    launches of :func:`label_components`."""
    B, H, W = _checked(fg)
    lib = native.load("cc", _SIG)

    def run(k: int) -> torch.Tensor:
        labels = torch.empty((B, H, W), dtype=torch.int32, device=fg.device)
        err = lib.cc_phases(native.ptr(fg), native.ptr(labels), B, H, W, k,
                            native.stream(fg.device))
        native.check(err, f"label_components {PHASES[k - 1]}")
        return labels

    return [(name, lambda k=k: run(k)) for k, name in enumerate(PHASES, 1)]


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
