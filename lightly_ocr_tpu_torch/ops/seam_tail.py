"""The detector's seam tail: upconv4 + conv_cls from the trunk's seam pair.

Port of ``lightly_ocr_tpu/ops/pallas_tail.py`` (``fused_tail_scores_cs_seam``
and its kernel ``_seam_kernel``).  Given the trunk's pre-concat pair
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
``csrc/seam_tail.cu`` or raises.  The plain version computes in the dtype of
``t``: bf16 inputs round at the kernel's cast points, float32 inputs (the
CPU parity tests) do not round at all.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from lightly_ocr_tpu_torch.ops import native


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


def seam_tail_plain(ya: torch.Tensor, t: torch.Tensor,
                    p: TailParams) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``ya`` [B, H/4, W/4, 64] f32,
    ``t`` [B, H/2, W/2, 128] -> [B, H/2, 2, W/2] f32."""
    if t.dtype == torch.float32:
        def q(x):
            return x
    else:
        def q(x):
            return x.to(t.dtype).float()

    B, H2, W2, _ = t.shape
    up = F.interpolate(ya.permute(0, 3, 1, 2).float(), size=(H2, W2),
                       mode="bilinear", align_corners=False)
    tn = t.permute(0, 3, 1, 2).float()
    yb = F.conv2d(tn, p.k1b.float().t()[:, :, None, None])
    x = q(F.relu(up + yb + p.b1[:, None, None]))
    for wk, bk in ((p.wa, p.ba), (p.w0, p.b0), (p.w2, p.b2), (p.w4, p.b4)):
        oihw = wk.float().reshape(3, 3, wk.shape[1], wk.shape[2]).permute(3, 2, 0, 1)
        x = q(F.relu(F.conv2d(x, oihw, bk, padding=1)))
    x = q(F.relu(F.conv2d(x, p.w6.float().t()[:, :, None, None], p.b6)))
    o = F.conv2d(x, p.w8.float().t()[:, :, None, None], p.b8)
    return o.permute(0, 2, 1, 3).contiguous()  # [B, H2, 2, W2]


_VP = ctypes.c_void_p
_SIG = {"seam_tail_launch": [_VP] * 20 + [ctypes.c_int] * 3 + [_VP]}


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
    for name, x in p._asdict().items():
        want = torch.float32 if name.startswith("b") or name == "k1a" else torch.bfloat16
        if x.dtype != want or x.device != t.device or not x.is_contiguous():
            raise ValueError(f"seam_tail: param {name} must be contiguous {want} on {t.device}, got {x.dtype} on {x.device}")
    lib = native.load("seam_tail", _SIG)
    xs = torch.empty((B, H2, W2, 64), dtype=torch.bfloat16, device=t.device)
    bufa = torch.empty((B, H2, W2, 32), dtype=torch.bfloat16, device=t.device)
    bufb = torch.empty_like(bufa)
    out = torch.empty((B, H2, 2, W2), dtype=torch.float32, device=t.device)
    args = [t, ya, p.k1b, p.b1, p.wa, p.ba, p.w0, p.b0, p.w2, p.b2,
            p.w4, p.b4, p.w6, p.b6, p.w8, p.b8, xs, bufa, bufb, out]
    err = lib.seam_tail_launch(
        *[native.ptr(a) for a in args], B, H2, W2, native.stream(t.device)
    )
    native.check(err, "seam_tail")
    seam_tail.launches += 1
    return out


seam_tail.launches = 0


def fused_tail_scores_cs_seam(p: TailParams, y_lo: torch.Tensor,
                              t: torch.Tensor) -> torch.Tensor:
    """Seam pair -> channels-second ``[B, H/2, 2, W/2]`` f32 scores: the
    quarter-resolution ``ya`` product (float32 matmul of compute-dtype
    values), then the tail kernel."""
    ya = torch.matmul(y_lo.to(t.dtype).float(), p.k1a).contiguous()
    return seam_tail(ya, t.contiguous(), p)
