"""Row-packed strided convs (port of ``lightly_ocr_tpu/ops/rowpack.py``).

The JAX package's A/B formulation of the detector's channel-poor 3x3 convs
for the TPU's 128-lane systolic array: a SAME 3x3 conv producing ``[B, H,
W, C]`` equals a strided conv producing ``G`` consecutive output rows as
``G*C`` output channels,

    y[b, G*t + q, c, o] = rowpacked[b, t, c, q*C + o]

with a ``[G+2, 3, Cin, G*C]`` kernel at stride ``(G, 1)`` whose blocks are
row-shifted copies of the taps, ``K[u, v, i, q*C + o] = k[u - q, v, i, o]``
(zero outside ``0 <= u - q < 3``).  The depth-packed form folds ``G`` rows
into the channels instead and runs unstrided.  The extra products multiply
structural zeros, so the arithmetic is the direct conv's up to the order of
the float32 sums.

The JAX package runs these in XLA, not Pallas, so the port runs them in
stock PyTorch: NHWC activations and HWIO kernels at the interface, as the
JAX functions take them, ``F.conv2d`` inside, float32 sums of the operands'
values.  ``BatchedOCR`` selects them with ``Config.fused_impl="rowpack"``
(``LIGHTLY_OCR_FUSED_IMPL``): :func:`stem_conv_rowpacked` for the ``stem``
plan's conv1_2 and :func:`tail_scores_rowpacked` for the tail, in place of
kernels #4 and #1.  ``LIGHTLY_OCR_ROWPACK_G`` forces the tail's ``G``.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F


def pack_kernel(k: torch.Tensor, G: int) -> torch.Tensor:
    """``[3, 3, Cin, C]`` conv kernel -> ``[G+2, 3, Cin, G*C]`` row-packed."""
    kh = k.shape[0]
    if kh != 3:
        raise ValueError("pack_kernel expects 3-row kernels")
    # output row q within the group uses taps u = q-1+0..2
    return torch.cat([F.pad(k, (0, 0, 0, 0, 0, 0, q, G - 1 - q)) for q in range(G)], -1)


def _unpack_rows(y: torch.Tensor, G: int, C: int) -> torch.Tensor:
    """NCHW ``[B, G*C, H/G, W]`` (channel ``q*C + o`` = row ``q`` of a group)
    -> NHWC ``[B, H, W, C]``."""
    B, _, Hg, W = y.shape
    return y.view(B, G, C, Hg, W).permute(0, 3, 1, 4, 2).reshape(B, Hg * G, W, C)


def conv3x3_rowpacked(x: torch.Tensor, k: torch.Tensor, G: int) -> torch.Tensor:
    """SAME 3x3 NHWC conv via the row-packed strided formulation.

    ``x`` [B, H, W, Cin] (H divisible by G), ``k`` [3, 3, Cin, C] -> [B, H,
    W, C] float32 (float32 sums of the operands' values)."""
    B, H, W, Cin = x.shape
    C = k.shape[-1]
    if H % G != 0:
        raise ValueError(f"H={H} not divisible by packing G={G}")
    kp = pack_kernel(k.float(), G).permute(3, 2, 0, 1)  # OIHW [G*C, Cin, G+2, 3]
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), kp, stride=(G, 1), padding=1)
    return _unpack_rows(y, G, C)


def pack_kernel_depth(k: torch.Tensor, G: int) -> torch.Tensor:
    """``[3, 3, Cin, C]`` -> ``[3, 3, G*Cin, G*C]`` for the depth-packed form:
    output row ``q_out`` of a group reads input row ``q_in`` of groups
    ``t-1 / t / t+1``; the ``(u, q_in, q_out)`` block is the original tap
    ``d = G*(u-1) + q_in - q_out + 1`` where ``0 <= d < 3``, else zero."""
    kh, kw, cin, cout = k.shape
    if kh != 3:
        raise ValueError("pack_kernel_depth expects 3-row kernels")
    kp = k.new_zeros((3, kw, G * cin, G * cout))
    for u in range(3):
        for qi in range(G):
            for qo in range(G):
                d = G * (u - 1) + qi - qo + 1
                if 0 <= d < 3:
                    kp[u, :, qi * cin:(qi + 1) * cin, qo * cout:(qo + 1) * cout] = k[d]
    return kp


def conv3x3_depthpacked(x: torch.Tensor, k: torch.Tensor, G: int) -> torch.Tensor:
    """SAME 3x3 NHWC conv via the depth-packed (rows-as-channels) form:
    ``G`` times the direct conv's products, unstrided, with ``G*Cin`` input
    and ``G*C`` output channels.  -> [B, H, W, C] float32."""
    B, H, W, Cin = x.shape
    C = k.shape[-1]
    if H % G != 0:
        raise ValueError(f"H={H} not divisible by packing G={G}")
    xr = x.reshape(B, H // G, G, W, Cin).permute(0, 2, 4, 1, 3).reshape(B, G * Cin, H // G, W)
    kp = pack_kernel_depth(k.float(), G).permute(3, 2, 0, 1)
    y = F.conv2d(xr.float(), kp, padding=1)  # [B, G*C, H/G, W]
    return _unpack_rows(y, G, C)


def stem_conv_rowpacked(x0: torch.Tensor, p) -> torch.Tensor:
    """conv1_1 activation ``[B, H, W, 64]`` -> ``ReLU(BN(conv1_2(x0)))``
    with conv1_2 row-packed (``G = 2``, 1 on an odd height): the stock-op
    counterpart of kernel #4 (``fused_stem_conv``), on the same folded
    bf16 weights (``StemParams.w1``, tap-major); ``x0`` rounded to bf16 as
    the kernel takes it, float32 sums, + bias, ReLU, cast to ``x0``'s
    dtype."""
    k = p.w1.float().view(3, 3, 64, 64)
    G = 2 if x0.shape[1] % 2 == 0 else 1
    y = conv3x3_rowpacked(x0.to(torch.bfloat16), k, G)
    return F.relu(y + p.b1).to(x0.dtype)


def rowpack_g(cout: int, h: int) -> int:
    """The tail's packing for a ``cout``-channel conv on ``h`` rows:
    ``LIGHTLY_OCR_ROWPACK_G`` if set, else ``min(max(1, 128 // cout), 8)``;
    halved until it divides ``h``."""
    force = os.environ.get("LIGHTLY_OCR_ROWPACK_G", "").strip()
    g = int(force) if force else min(max(1, 128 // cout), 8)
    while g > 1 and h % g != 0:
        g //= 2
    return g


def tail_scores_rowpacked(y192: torch.Tensor, p) -> torch.Tensor:
    """``[B, H2, W2, 192]`` trunk concat -> ``[B, H2, W2, 2]`` float32 score
    maps: upconv4's 1x1 and the folded BNs of :class:`~lightly_ocr_tpu_torch.
    ops.seam_tail.TailParams`, the 3x3 convs (upconv4's and the head's
    three) row-packed, the two 1x1s as matmuls.  Every product sums in
    float32 and each ReLU's output rounds to ``y192``'s dtype, as in the JAX
    function (which computes in bfloat16)."""
    dtype = y192.dtype
    H2 = y192.shape[1]
    k1 = torch.cat([p.k1a.float(), p.k1b.float()])  # [192, 64]
    x = F.relu(y192.float() @ k1 + p.b1).to(dtype)
    for wk, bk in ((p.wa, p.ba), (p.w0, p.b0), (p.w2, p.b2), (p.w4, p.b4)):
        k = wk.float().view(3, 3, wk.shape[1], wk.shape[2])
        x = F.relu(conv3x3_rowpacked(x, k, rowpack_g(k.shape[-1], H2)) + bk).to(dtype)
    e = F.relu(x.float() @ p.w6.float() + p.b6).to(dtype)
    return e.float() @ p.w8.float() + p.b8
