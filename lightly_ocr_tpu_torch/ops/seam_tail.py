"""The detector's tail: upconv4 + conv_cls, from the seam pair or from x.

Port of ``lightly_ocr_tpu/ops/pallas_tail.py`` (``fused_tail_scores_cs_seam``
with its kernel ``_seam_kernel``, and ``fused_tail_scores_cs``,
``fused_tail_scores`` and the legacy branch of ``fused_tail_scores_cs_seam``
with their kernel ``_tail_kernel``).  Given the trunk's pre-concat pair
``(y_lo [B, H/4, W/4, 64], t [B, H/2, W/2, 128])`` it computes

    xs = bf16(relu(up2x(y_lo @ k1[:64]) + t @ k1[64:] + b1))   upconv4 1x1+BN
    x  = bf16(relu(conv3x3(xs) + ba))                           upconv4 3x3+BN
    x  = bf16(relu(conv3x3(x) + b))   x3 (conv_cls 0, 2, 4: 32, 32, 16 ch)
    x  = bf16(relu(x @ w6 + b6));  scores = x @ w8 + b8          conv_cls 6, 8

with every product accumulated in float32, and returns the scores
channels-second, ``[B, H/2, 2, W/2]`` float32, as the TPU kernel does.  BN is
folded into the convs (:func:`tail_params`).  The quarter-resolution product
``ya = y_lo @ k1[:64]`` runs as a float32 ``torch.matmul`` outside the
kernel, as the JAX package runs it in XLA.

:func:`seam_tail` is the kernel's wrapper: a CPU tensor takes the plain
version :func:`seam_tail_plain`; a CUDA tensor launches the CUDA kernel of
``csrc/seam_tail.cu`` or raises.  :func:`tail_scores` (plain version
:func:`tail_scores_plain`) is the same for kernel #3, the chain after ``xs``
from a formed ``x [B, H/2, W/2, 64]``: the TPU package's ``_scores_from_x``.
The plain versions compute in the dtype of ``t`` (or ``x``): bf16 inputs
round at the kernel's cast points, float32 inputs (the CPU parity tests) do
not round at all.

Both kernels are one launch each (one fused tensor-core kernel: ``xs`` and
the chain's intermediates stay in shared memory), so a wrapper allocates
only its output, ``[B, H2, 2, W2]`` float32.  A block of the kernel owns
one sample, a strip of :data:`STRIP_COLS` output columns and a segment of
:data:`SEGMENT_ROWS` output rows, and computes :data:`HALO` more columns on
each side and rows above and below, with the activations outside the image
set to zero after every layer (SAME padding); ``tests/test_torch_seam_tail.py``
replays that cut in PyTorch.

The legacy branch of :func:`fused_tail_scores_cs_seam` forms ``x`` with the
front's products in PyTorch and runs kernel #3.  It is taken, as in the JAX
package, when ``LIGHTLY_OCR_TAIL_SEAMK=0`` (read at call time) or when
``y_lo`` is not half the resolution of ``t``; the JAX package's third
reason, a canvas without a seam row split, does not apply, because the
port's seam kernel takes every even size.
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from lightly_ocr_tpu_torch.ops import native
from lightly_ocr_tpu_torch.utils.profiling import annotate


class TailParams(NamedTuple):
    k1a: torch.Tensor  # [64, 64] f32 (compute-dtype values): y half of the 1x1
    k1b: torch.Tensor  # [128, 64] (in, out): skip half of the 1x1
    b1: torch.Tensor  # [64] f32
    wa: torch.Tensor  # [9, 64, 32] (tap = 3*dy + dx, in, out)
    ba: torch.Tensor
    w0: torch.Tensor  # [9, 32, 32]
    b0: torch.Tensor
    w2: torch.Tensor  # [9, 32, 32]
    b2: torch.Tensor
    w4: torch.Tensor  # [9, 32, 16]
    b4: torch.Tensor
    w6: torch.Tensor  # [16, 16] (in, out)
    b6: torch.Tensor
    w8: torch.Tensor  # [16, 2] (in, out)
    b8: torch.Tensor


def fold_bn(conv, bn) -> tuple[torch.Tensor, torch.Tensor]:
    """conv(+bias) -> BN == one conv with folded weight and bias
    (inference), in float32."""
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    w = conv.weight.float() * s[:, None, None, None]
    b = (conv.bias.float() - bn.running_mean.float()) * s + bn.bias.float()
    return w, b


def _taps(w: torch.Tensor) -> torch.Tensor:
    """OIHW 3x3 -> [9, in, out]."""
    return w.permute(2, 3, 1, 0).reshape(9, w.shape[1], w.shape[0])


@torch.no_grad()
def tail_params(det_net, dtype: torch.dtype = torch.bfloat16) -> TailParams:
    """Folded tail operands from a :class:`VGG_UNet`'s ``upconv4`` and
    ``conv_cls``; weights in ``dtype``, biases in float32."""
    u, h = det_net.upconv4.conv, det_net.conv_cls
    k1, b1 = fold_bn(u["0"], u["1"])
    k1 = k1[:, :, 0, 0].t()  # [192, 64]
    ka, ba = fold_bn(u["3"], u["4"])

    # copies: the module's parameters are cast in place by a later .to()
    def w(x):
        return x.detach().to(dtype).clone().contiguous()

    def b(x):
        return x.detach().float().clone().contiguous()

    return TailParams(
        k1a=w(k1[:64]).float(), k1b=w(k1[64:]), b1=b(b1),
        wa=w(_taps(ka)), ba=b(ba),
        w0=w(_taps(h["0"].weight.float())), b0=b(h["0"].bias),
        w2=w(_taps(h["2"].weight.float())), b2=b(h["2"].bias),
        w4=w(_taps(h["4"].weight.float())), b4=b(h["4"].bias),
        w6=w(h["6"].weight.float()[:, :, 0, 0].t()), b6=b(h["6"].bias),
        w8=w(h["8"].weight.float()[:, :, 0, 0].t()), b8=b(h["8"].bias),
    )


def _front(ya: torch.Tensor, t: torch.Tensor, p: TailParams) -> torch.Tensor:
    """``xs = relu(up(ya) + t @ k1b + b1)`` in float32, cast to the dtype of
    ``t``: ``[B, H/2, W/2, 64]`` NHWC (``up`` resizes ``ya`` to ``t``'s
    size, bilinear with half-pixel centres)."""
    B, H2, W2, _ = t.shape
    up = F.interpolate(ya.permute(0, 3, 1, 2).float(), size=(H2, W2),
                       mode="bilinear", align_corners=False)
    tn = t.permute(0, 3, 1, 2).float()
    yb = F.conv2d(tn, p.k1b.float().t()[:, :, None, None])
    return F.relu(up + yb + p.b1[:, None, None]).to(t.dtype).permute(0, 2, 3, 1)


def tail_scores_plain(x: torch.Tensor, p: TailParams) -> torch.Tensor:
    """Plain PyTorch version of kernel #3: ``x`` [B, H/2, W/2, 64] ->
    [B, H/2, 2, W/2] f32, rounding to the dtype of ``x`` after every ReLU."""
    dtype = x.dtype

    def q(y):
        return y if dtype == torch.float32 else y.to(dtype).float()

    x = x.permute(0, 3, 1, 2).float()
    for wk, bk in ((p.wa, p.ba), (p.w0, p.b0), (p.w2, p.b2), (p.w4, p.b4)):
        oihw = wk.float().reshape(3, 3, wk.shape[1], wk.shape[2]).permute(3, 2, 0, 1)
        x = q(F.relu(F.conv2d(x, oihw, bk, padding=1)))
    x = q(F.relu(F.conv2d(x, p.w6.float().t()[:, :, None, None], p.b6)))
    o = F.conv2d(x, p.w8.float().t()[:, :, None, None], p.b8)
    return o.permute(0, 2, 1, 3).contiguous()  # [B, H2, 2, W2]


def seam_tail_plain(ya: torch.Tensor, t: torch.Tensor,
                    p: TailParams) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``ya`` [B, H/4, W/4, 64] f32,
    ``t`` [B, H/2, W/2, 128] -> [B, H/2, 2, W/2] f32."""
    return tail_scores_plain(_front(ya, t, p), p)


# The kernel's geometry (csrc/seam_tail.cu kTW, kSeg, kHalo; the library
# reports its own through kernel_geometry()).
STRIP_COLS = 56  # output columns of a block
SEGMENT_ROWS = 120  # output rows of a block
HALO = 4  # extra columns each side / rows above and below: four 3x3 convs

_VP = ctypes.c_void_p
_SIG = {"seam_tail_launch": [_VP] * 17 + [ctypes.c_int] * 3 + [_VP],
        "tail_launch": [_VP] * 14 + [ctypes.c_int] * 3 + [_VP],
        "seam_tail_geometry": [_VP]}
_CHAIN = ("wa", "ba", "w0", "b0", "w2", "b2", "w4", "b4", "w6", "b6", "w8", "b8")


def _check_params(name: str, p: TailParams, fields, device) -> None:
    for f in fields:
        x = getattr(p, f)
        want = torch.float32 if f.startswith("b") or f == "k1a" else torch.bfloat16
        if x.dtype != want or x.device != device or not x.is_contiguous():
            raise ValueError(f"{name}: param {f} must be contiguous {want} on {device}, got {x.dtype} on {x.device}")


def seam_tail(ya: torch.Tensor, t: torch.Tensor, p: TailParams) -> torch.Tensor:
    """Kernel wrapper.  CPU tensors take :func:`seam_tail_plain`; CUDA
    tensors launch ``csrc/seam_tail.cu`` (bf16 ``t``, f32 ``ya``, params
    from :func:`tail_params` with ``dtype=torch.bfloat16``) or raise."""
    if t.device.type == "cpu":
        return seam_tail_plain(ya, t, p)
    if t.device.type != "cuda":
        raise ValueError(f"seam_tail: unsupported device {t.device}")
    B, H2, W2, C = t.shape
    if C != 128 or t.dtype != torch.bfloat16 or not t.is_contiguous():
        raise ValueError(f"seam_tail: t must be contiguous bf16 [B, H2, W2, 128], got {t.dtype} {tuple(t.shape)}")
    if H2 % 2 or W2 % 2:
        raise ValueError(f"seam_tail: H2, W2 must be even, got {H2}x{W2}")
    if (ya.shape != (B, H2 // 2, W2 // 2, 64) or ya.dtype != torch.float32
            or not ya.is_contiguous() or ya.device != t.device):
        raise ValueError(f"seam_tail: ya must be contiguous f32 [B, H2/2, W2/2, 64] on {t.device}, got {ya.dtype} {tuple(ya.shape)}")
    _check_params("seam_tail", p, p._fields, t.device)
    lib = native.load("seam_tail", _SIG)
    out = torch.empty((B, H2, 2, W2), dtype=torch.float32, device=t.device)
    args = [t, ya, p.k1b, p.b1, p.wa, p.ba, p.w0, p.b0, p.w2, p.b2,
            p.w4, p.b4, p.w6, p.b6, p.w8, p.b8, out]
    with annotate("seam_tail"):  # the span a trace names it by
        err = lib.seam_tail_launch(
            *[native.ptr(a) for a in args], B, H2, W2, native.stream(t.device)
        )
    native.check(err, "seam_tail")
    native.count_launch(seam_tail)
    return out


def tail_scores(x: torch.Tensor, p: TailParams) -> torch.Tensor:
    """Kernel #3's wrapper.  CPU tensors take :func:`tail_scores_plain`;
    CUDA tensors launch ``tail_launch`` of ``csrc/seam_tail.cu`` (contiguous
    bf16 ``x`` [B, H2, W2, 64], H2 and W2 even) or raise."""
    if x.device.type == "cpu":
        return tail_scores_plain(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"tail_scores: unsupported device {x.device}")
    if x.ndim != 4 or x.shape[3] != 64 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"tail_scores: x must be contiguous bf16 [B, H2, W2, 64], got {x.dtype} {tuple(x.shape)}")
    B, H2, W2, _ = x.shape
    if H2 % 2 or W2 % 2:
        raise ValueError(f"tail_scores: H2, W2 must be even, got {H2}x{W2}")
    _check_params("tail_scores", p, _CHAIN, x.device)
    lib = native.load("seam_tail", _SIG)
    out = torch.empty((B, H2, 2, W2), dtype=torch.float32, device=x.device)
    args = [x, *(getattr(p, f) for f in _CHAIN), out]
    err = lib.tail_launch(*[native.ptr(a) for a in args], B, H2, W2, native.stream(x.device))
    native.check(err, "tail_scores")
    native.count_launch(tail_scores)
    return out


seam_tail.launches = 0
tail_scores.launches = 0


def kernel_geometry() -> tuple[int, int, int]:
    """``(strip columns, segment rows, halo)`` as compiled into the CUDA
    library (builds it on first use; needs ``nvcc``)."""
    lib = native.load("seam_tail", _SIG)
    g = (ctypes.c_int * 3)()
    lib.seam_tail_geometry(g)
    return tuple(g)


def fused_tail_scores_cs(p: TailParams, y192: torch.Tensor) -> torch.Tensor:
    """The concat-fed tail: ``[B, H/2, W/2, 192]`` (``cat([up(y_lo), t])``)
    -> channels-second ``[B, H/2, 2, W/2]`` f32 scores.  The K=192 upconv4
    1x1 runs as a float32 ``torch.matmul`` of compute-dtype operands (the
    JAX package runs it in XLA), then bias, ReLU and one cast form ``x`` for
    kernel #3.  Exactly ``W/2`` columns, where the TPU kernel pads."""
    dtype = p.k1b.dtype
    k1 = torch.cat([p.k1a, p.k1b.float()])
    x = torch.matmul(y192.to(dtype).float(), k1)
    return tail_scores(F.relu(x + p.b1).to(dtype).contiguous(), p)


def fused_tail_scores(p: TailParams, y192: torch.Tensor) -> torch.Tensor:
    """Channels-last form of :func:`fused_tail_scores_cs`:
    ``[B, H/2, W/2, 2]``."""
    return fused_tail_scores_cs(p, y192).permute(0, 1, 3, 2)


def fused_tail_scores_cs_seam(p: TailParams, y_lo: torch.Tensor,
                              t: torch.Tensor) -> torch.Tensor:
    """Seam pair -> channels-second ``[B, H/2, 2, W/2]`` f32 scores: the
    quarter-resolution ``ya`` product (float32 matmul of compute-dtype
    values), then the seam kernel; or, on the legacy branch of the module
    docstring, ``x`` formed from ``ya`` and ``t`` in PyTorch, then
    kernel #3."""
    ya = torch.matmul(y_lo.to(t.dtype).float(), p.k1a).contiguous()
    H2, W2 = t.shape[1:3]
    if (os.environ.get("LIGHTLY_OCR_TAIL_SEAMK", "1") == "0"
            or y_lo.shape[1:3] != (H2 // 2, W2 // 2)):
        return tail_scores(_front(ya, t, p).contiguous(), p)
    return seam_tail(ya, t.contiguous(), p)
