"""The fused conv1_2 detector front (kernels of ``csrc/stem.cu``).

Port of the four kernels of ``lightly_ocr_tpu/ops/pallas_stem.py``
(``fused_stem_conv``, ``fused_conv12_pool``, ``fused_conv12_pool_conv21``
and ``fused_conv12_pool_conv21_q``).  Each takes the conv1_1 activation
``x0`` ``[B, H, W, 64]`` NHWC (:meth:`VGG_UNet.stem_prefix`) and computes,
with BN folded into the convs (:func:`stem_params`):

* :func:`fused_stem_conv`: ``relu(conv1_2(x0) + b1)`` at full resolution ->
  ``[B, H, W, 64]`` bf16 (the ``stem`` plan; the trunk pools it);
* :func:`fused_conv12_pool`: ``pool2x2(relu(conv1_2(x0) + b1))`` ->
  ``[B, H/2, W/2, 64]`` bf16;
* :func:`fused_conv12_pool_conv21`: that pooled map cast to bf16, then
  ``relu(conv2_1(p) + b2)`` with zero padding -> ``[B, H/2, W/2, 128]`` bf16;
* :func:`fused_conv12_pool_conv21_q`: the w8a8 form: ``x0`` quantized per
  sample, int8 conv1_2 with int32 sums dequantized by ``sx * sw1``, bias,
  ReLU, pool in float32; the pooled map requantized per row block of
  ``rows / 2`` pooled rows with ``s2 = max(amax, 1e-12) / 127`` over the
  block's rows and one halo row on each side (``pallas_stem.py:641-651``),
  every row that a block reads quantized with that block's ``s2``; int8
  conv2_1 dequantized by ``s2 * sw2``, bias, ReLU -> bf16.

  Rounding of #7 is that of the JAX kernel as XLA runs it: each dequant
  ``y * s + b`` is one fused multiply-add (one rounding), the requant
  multiplies by the float32 reciprocal of ``s2``, and the scales that the
  jitted JAX wrapper takes outside its kernel (``sx``, ``sw1``, ``sw2``)
  are ``max(amax, 1e-12)`` times the float32 constant ``1 / 127``, which is
  how XLA simplifies a division by a constant (:func:`scale127`); ``s2``,
  taken inside the kernel, is a true division.  (Rounded apart, with a
  true division, an int8 code flips at a .5 boundary about once per 10^5
  values against the JAX kernel.)  The plain version computes the FMA
  exactly in float64 and the CUDA kernel with ``__fmaf_rn``, so the two
  agree bit for bit: every int8 product and int32 sum is exact.

Each wrapper takes its plain PyTorch version (``*_plain``) for a CPU tensor,
and for a CUDA tensor launches the kernels or raises.  The trunk resumes
after them through ``VGG_UNet.trunk(..., resume="stem" | "pool" | "c21")``.

Every convolution runs ``conv3x3_hopper`` (bf16 for #4-#6, s8 for #7): a
block owns one sample, a strip of :data:`STRIP_COLS` output columns and a
segment of :data:`SEGMENT_ROWS` output rows (#7's conv1_2:
:data:`S8_SEGMENT_ROWS`; its conv2_1: one requant block), reads
:data:`HALO` more input rows and columns on each side (zeros outside the
image), and pools the two conv rows of a step in registers.
#7's conv1_2 also takes each pooled row's max, from which its conv2_1
forms the block scales; ``tests/test_torch_stem.py`` replays both cuts in
PyTorch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from lightly_ocr_tpu_torch.models.layers import (
    int8_conv,
    int8_scale,
    quantize_with,
    tap_major,
)
from lightly_ocr_tpu_torch.ops import native
from lightly_ocr_tpu_torch.ops.seam_tail import fold_bn
from lightly_ocr_tpu_torch.utils.profiling import annotate


class StemParams(NamedTuple):
    w0: torch.Tensor  # [64, 3, 3, 3] bf16 OIHW, conv1_1 + BN folded
    b0: torch.Tensor  # [64] f32
    w1: torch.Tensor  # [576, 64] bf16, conv1_2 + BN folded, K tap-major
    b1: torch.Tensor  # [64] f32
    w2: torch.Tensor  # [576, 128] bf16, conv2_1 + BN folded
    b2: torch.Tensor  # [128] f32
    q1: torch.Tensor  # [576, 64] int8 codes of the folded float32 conv1_2
    sw1: torch.Tensor  # [64] f32 per-out-channel scales
    q2: torch.Tensor  # [576, 128] int8
    sw2: torch.Tensor  # [128] f32


@torch.no_grad()
def stem_params(det_net) -> StemParams:
    """Folded conv1_1 (slice1 ``0``/``1``), conv1_2 (``3``/``4``) and
    conv2_1 (``7``/``8``) of a float32 :class:`VGG_UNet`: BN folded in
    float32, then the bf16 kernels (``conv12_params``/``conv21_params``,
    ``s2d_stem._stem_folded``) and the int8 codes of the folded float32
    kernels (``_wtap_q``)."""
    s1 = det_net.basenet.slice1
    k0, b0 = fold_bn(s1["0"], s1["1"])
    k1, b1 = fold_bn(s1["3"], s1["4"])
    k2, b2 = fold_bn(s1["7"], s1["8"])
    sw1 = scale127(k1.abs().amax(dim=(1, 2, 3)))
    sw2 = scale127(k2.abs().amax(dim=(1, 2, 3)))
    q1 = quantize_with(k1, sw1[:, None, None, None])
    q2 = quantize_with(k2, sw2[:, None, None, None])
    return StemParams(
        w0=k0.to(torch.bfloat16).contiguous(), b0=b0.contiguous(),
        w1=tap_major(k1).to(torch.bfloat16), b1=b1.contiguous(),
        w2=tap_major(k2).to(torch.bfloat16), b2=b2.contiguous(),
        q1=tap_major(q1), sw1=sw1.contiguous(), q2=tap_major(q2), sw2=sw2.contiguous(),
    )


def stem_supported(h: int) -> bool:
    """The JAX package's ``pallas_stem.stem_supported``: a row block of
    ``pallas_tail._pick_rows`` exists, i.e. ``h`` is a multiple of 4."""
    return h % 4 == 0


def scale127(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-12) / 127`` as kernel #7's jitted JAX wrapper
    computes it: times the float32 constant ``1 / 127`` (XLA rewrites a
    division by a constant so; it differs from the true quotient in the
    last bit now and then, which moves every int8 code of a sample)."""
    a = amax.float().clamp_min(1e-12)
    return a * torch.full_like(a, _RCP127)


_RCP127 = float(torch.tensor(1.0) / torch.tensor(127.0))  # exact in float32


def _pick_rows_even(h: int) -> int:
    """Largest even row block dividing ``h`` from the supported set (the
    JAX package's ``pallas_stem._pick_rows_even``)."""
    for r in (32, 16, 8, 4, 2):
        if h % r == 0:
            return r
    return 0


def conv_pool_supported(h: int, w: int) -> bool:
    return h % 2 == 0 and w % 16 == 0 and _pick_rows_even(h) != 0


def s2d_supported(h: int, w: int) -> bool:
    """The JAX package's ``s2d_stem.s2d_supported``: the space-to-depth stem
    pairs source rows and columns, so it takes every even canvas."""
    return h % 2 == 0 and w % 2 == 0


def _oihw(w_km: torch.Tensor) -> torch.Tensor:
    """[9 * I, O] tap-major -> OIHW float32."""
    O = w_km.shape[1]
    return w_km.float().view(3, 3, -1, O).permute(3, 2, 0, 1)


def _conv_bias_relu(x_nhwc: torch.Tensor, w_km: torch.Tensor, b: torch.Tensor):
    """float32 SAME 3x3 conv, then + bias, then ReLU (NCHW out)."""
    y = F.conv2d(x_nhwc.permute(0, 3, 1, 2).float(), _oihw(w_km), padding=1)
    return F.relu(y + b[:, None, None])


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def s2d_prefix(x: torch.Tensor, p: StemParams) -> torch.Tensor:
    """conv1_1 as the JAX package's space-to-depth stem computes it
    (``ops/s2d_stem.py``): canvas ``[B, H, W, 3]`` and folded weights in
    bf16, float32 sums, + bias, ReLU, one cast -> ``[B, H, W, 64]`` bf16,
    the input of kernel #5 on the ``s2d`` plan.  The products of bf16
    values are exact in float32 (and in TF32), so any float32 convolution
    gives these sums."""
    x = x.permute(0, 3, 1, 2).to(torch.bfloat16).float()
    y = F.conv2d(x, p.w0.float(), padding=1)
    return _nhwc(F.relu(y + p.b0[:, None, None])).to(torch.bfloat16)


def fused_stem_conv_plain(x0: torch.Tensor, p: StemParams) -> torch.Tensor:
    """Plain version of kernel #4: ``x0`` cast to bf16, bf16 weights (their
    products are exact in float32), float32 sums, float32 bias and ReLU,
    one cast to bf16."""
    x0 = x0.to(torch.bfloat16)
    return _nhwc(_conv_bias_relu(x0, p.w1, p.b1)).to(torch.bfloat16)


def conv12_pool_plain(x0: torch.Tensor, p: StemParams) -> torch.Tensor:
    """Plain version of kernel #5: bf16 operands upcast (their products are
    exact in float32), float32 sums, bias, ReLU, 2x2 max, one cast."""
    x0 = x0.to(torch.bfloat16)
    return _nhwc(F.max_pool2d(_conv_bias_relu(x0, p.w1, p.b1), 2)).to(torch.bfloat16)


def conv12_pool_conv21_plain(x0: torch.Tensor, p: StemParams) -> torch.Tensor:
    """Plain version of kernel #6: #5's bf16 pooled map, then conv2_1 with
    zero padding, bias, ReLU, bf16."""
    return _nhwc(_conv_bias_relu(conv12_pool_plain(x0, p), p.w2, p.b2)).to(torch.bfloat16)


def requant_windows(pooled: torch.Tensor, rows: int):
    """The f32 pooled map ``[B, H2, W2, C]`` -> (windows ``[B, nblk, r2 + 2,
    W2, C]``: each block's ``r2 = rows / 2`` pooled rows with one halo row
    on each side, zero outside the map; ``s2 [B, nblk]``)."""
    r2 = rows // 2
    padded = F.pad(pooled, (0, 0, 0, 0, 1, 1))
    win = padded.unfold(1, r2 + 2, r2).permute(0, 1, 4, 2, 3)
    s2 = int8_scale(win.abs().amax(dim=(2, 3, 4)))
    return win, s2


def _fma(a: torch.Tensor, s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a * s + b`` with one rounding: the product of two float32
    values is exact in float64, and so, but for a double rounding too rare
    to meet, is the sum."""
    return (a.double() * s.double() + b.double()).float()


def conv12_pool_conv21_q_plain(x0: torch.Tensor, p: StemParams) -> torch.Tensor:
    """Plain version of kernel #7, with :func:`int8_conv` (exact int32
    sums) for both convs and the blockwise requant of
    :func:`requant_windows`."""
    B, H, W, _ = x0.shape
    xf = x0.float()
    sx = scale127(xf.abs().amax(dim=(1, 2, 3), keepdim=True))
    xq = quantize_with(xf, sx)
    a = _fma(int8_conv(xq, p.q1, padding=(1, 1)).float(), sx * p.sw1, p.b1)
    pooled = _nhwc(F.max_pool2d(F.relu(a).permute(0, 3, 1, 2), 2))
    win, s2 = requant_windows(pooled, _pick_rows_even(H))
    nblk, r2 = win.shape[1], win.shape[2] - 2
    s2 = s2[:, :, None, None, None]
    q = torch.clamp(torch.round(win * (torch.ones_like(s2) / s2)), -127, 127).to(torch.int8)
    y = int8_conv(q.reshape(B * nblk, *q.shape[2:]), p.q2, padding=(0, 1))
    y = _fma(y.view(B, nblk, r2, W // 2, -1).float(), s2 * p.sw2, p.b2)
    return F.relu(y).reshape(B, H // 2, W // 2, -1).to(torch.bfloat16)


# conv3x3_hopper's geometry (csrc/stem.cu ``HGeo``; the library reports its
# own through kernel_geometry()), keyed by output channels: 64 = conv1_2
# (#4, #5 = #6's first launch, #7's conv1_2), 128 = conv2_1 (#6's second
# launch; #7's conv2_1 takes the strip, and a requant block as its segment).
STRIP_COLS = {64: 128, 128: 64}  # output columns of a block
SEGMENT_ROWS = {64: 120, 128: 60}  # output rows of a block (even: the pool's row pairs)
# #7's conv1_2 runs two blocks an SM, and segments half as long
S8_BLOCKS, S8_SEGMENT_ROWS = 2, 60
HALO = 1  # input rows above and below, columns each side: one 3x3 conv
RING_ROWS = 8  # input rows in shared memory: 4 in use, 2 steps of 2 in flight
STAGE_ROWS = 4  # #7's conv2_1: float32 rows copied ahead, quantized into the ring


def smem_bytes(cout: int, s8: bool = False) -> int:
    """Shared memory of a ``conv3x3_hopper`` block: 1,024 B of alignment
    slack, the weights as K-major tiles of 128 bytes a row (bf16: a tap a
    tile; s8: two taps a tile, 5 tiles), the f32 bias (s8: and the weight
    scales), the ring of input rows (``STRIP_COLS + 2 HALO`` pixels of 64
    channels), and for the s8 conv2_1 the float32 staging rows."""
    pix = STRIP_COLS[cout] + 2 * HALO
    esize = 1 if s8 else 2
    tiles = -(-9 * 64 * esize // 128)
    stage = STAGE_ROWS * pix * 64 * 4 if s8 and cout == 128 else 0
    return (1024 + tiles * cout * 128 + cout * 4 * (2 if s8 else 1) + RING_ROWS * pix * 64 * esize
            + stage)


def geometry() -> tuple[int, ...]:
    """The wrapper's copy of ``stem_geometry()``'s tuple."""
    return (STRIP_COLS[64], SEGMENT_ROWS[64], STRIP_COLS[128], SEGMENT_ROWS[128],
            S8_SEGMENT_ROWS, S8_BLOCKS, HALO, RING_ROWS, STAGE_ROWS, smem_bytes(64),
            smem_bytes(128), smem_bytes(64, s8=True), smem_bytes(128, s8=True))


_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {
    "conv12_bf16": [_VP] * 4 + [_I] * 3 + [_VP],
    "conv12_pool_bf16": [_VP] * 4 + [_I] * 3 + [_VP],
    "stem_geometry": [_VP],
    "conv21_bf16": [_VP] * 4 + [_I] * 3 + [_VP],
    "sample_amax_bf16": [_VP] * 2 + [_I, ctypes.c_longlong, _VP],
    "quantize_bf16": [_VP] * 4 + [_I, ctypes.c_longlong, _VP],
    "conv12_pool_s8": [_VP] * 7 + [_I] * 3 + [_VP],
    "conv21_s8": [_VP] * 6 + [_I] * 4 + [_VP],
}


def _check(name: str, x0: torch.Tensor, p: StemParams, fields) -> None:
    if x0.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x0.device}")
    if x0.ndim != 4 or x0.shape[3] != 64 or x0.dtype != torch.bfloat16 or not x0.is_contiguous():
        raise ValueError(f"{name}: x0 must be contiguous bf16 [B, H, W, 64], got {x0.dtype} {tuple(x0.shape)}")
    if name == "fused_stem_conv":
        if not stem_supported(x0.shape[1]) or x0.shape[2] % 8:
            raise ValueError(f"{name}: unsupported size {x0.shape[1]}x{x0.shape[2]} (H % 4 == 0, W % 8 == 0)")
    elif not conv_pool_supported(x0.shape[1], x0.shape[2]):
        raise ValueError(f"{name}: unsupported size {x0.shape[1]}x{x0.shape[2]} (H even with an even row split, W % 16 == 0)")
    for f in fields:
        t = getattr(p, f)
        want = {"w": torch.bfloat16, "b": torch.float32, "q": torch.int8, "s": torch.float32}[f[0]]
        if t.dtype != want or t.device != x0.device or not t.is_contiguous():
            raise ValueError(f"{name}: param {f} must be contiguous {want} on {x0.device}, got {t.dtype} on {t.device}")


def kernel_geometry() -> tuple[int, ...]:
    """``stem_geometry()`` as compiled into the CUDA library (builds it on
    first use; needs ``nvcc``)."""
    lib = native.load("stem", _SIG)
    g = (ctypes.c_int * 13)()
    lib.stem_geometry(g)
    return tuple(g)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The stem library, its ``conv3x3_hopper`` geometry checked against
    :func:`geometry` once."""
    got = kernel_geometry()
    if got != geometry():
        raise RuntimeError(f"csrc/stem.cu geometry {got} != ops/stem.py {geometry()}")
    return native.load("stem", _SIG)


def _pooled(x0: torch.Tensor, p: StemParams) -> torch.Tensor:
    """The bf16 pooled map of #5, which is also #6's first launch
    (``conv12_pool_bf16``)."""
    B, H, W, _ = x0.shape
    out = torch.empty((B, H // 2, W // 2, 64), dtype=torch.bfloat16, device=x0.device)
    with annotate("conv12_pool"):  # the span a trace names it by
        native.check(_lib().conv12_pool_bf16(*map(native.ptr, (x0, p.w1, p.b1, out)), B, H, W,
                                             native.stream(x0.device)), "conv12_pool_bf16")
    return out


def fused_stem_conv(x0: torch.Tensor, p: StemParams) -> torch.Tensor:
    """Kernel #4: conv1_2 + BN + ReLU at full resolution, ``[B, H, W, 64]``
    bf16 -> ``[B, H, W, 64]`` bf16 (``H % 4 == 0``, ``W % 8 == 0``)."""
    if x0.device.type == "cpu":
        return fused_stem_conv_plain(x0, p)
    _check("fused_stem_conv", x0, p, ("w1", "b1"))
    B, H, W, _ = x0.shape
    out = torch.empty((B, H, W, 64), dtype=torch.bfloat16, device=x0.device)
    native.check(_lib().conv12_bf16(*map(native.ptr, (x0, p.w1, p.b1, out)), B, H, W,
                                    native.stream(x0.device)), "conv12_bf16")
    native.count_launch(fused_stem_conv)
    return out


def fused_conv12_pool(x0: torch.Tensor, p: StemParams) -> torch.Tensor:
    """Kernel #5: conv1_2 + BN + ReLU + 2x2 pool, ``[B, H, W, 64]`` bf16 ->
    ``[B, H/2, W/2, 64]`` bf16."""
    if x0.device.type == "cpu":
        return conv12_pool_plain(x0, p)
    _check("fused_conv12_pool", x0, p, ("w1", "b1"))
    out = _pooled(x0, p)
    native.count_launch(fused_conv12_pool)
    return out


def fused_conv12_pool_conv21(x0: torch.Tensor, p: StemParams) -> torch.Tensor:
    """Kernel #6: #5, then conv2_1 + BN + ReLU -> ``[B, H/2, W/2, 128]``
    bf16 (two launches of ``conv3x3_hopper``; the pooled map goes through
    device memory in bf16)."""
    if x0.device.type == "cpu":
        return conv12_pool_conv21_plain(x0, p)
    _check("fused_conv12_pool_conv21", x0, p, ("w1", "b1", "w2", "b2"))
    B, H, W, _ = x0.shape
    pooled = _pooled(x0, p)
    out = torch.empty((B, H // 2, W // 2, 128), dtype=torch.bfloat16, device=x0.device)
    native.check(_lib().conv21_bf16(*map(native.ptr, (pooled, p.w2, p.b2, out)), B, H // 2,
                                    W // 2, native.stream(x0.device)), "conv21_bf16")
    native.count_launch(fused_conv12_pool_conv21)
    return out


def int8_launches(x0: torch.Tensor, p: StemParams):
    """Kernel #7's four launches on ``x0``, not yet run: ``(out, [(name,
    launch), ...])`` in order; each launch reads what the ones before it
    wrote, and may be run again on its own (for timing).  ``x0`` and ``p``
    as :func:`fused_conv12_pool_conv21_q` checks them."""
    B, H, W, _ = x0.shape
    H2, W2, r2 = H // 2, W // 2, _pick_rows_even(H) // 2
    lib, s, dev = _lib(), native.stream(x0.device), x0.device
    amax = torch.empty((B,), dtype=torch.float32, device=dev)
    xq = torch.empty(x0.shape, dtype=torch.int8, device=dev)
    sx = torch.empty((B,), dtype=torch.float32, device=dev)
    pooled = torch.empty((B, H2, W2, 64), dtype=torch.float32, device=dev)
    rowmax = torch.empty((B, H2), dtype=torch.float32, device=dev)
    out = torch.empty((B, H2, W2, 128), dtype=torch.bfloat16, device=dev)
    ptr = native.ptr
    steps = [
        ("sample_amax_bf16", lambda: lib.sample_amax_bf16(ptr(x0), ptr(amax), B, H * W * 64, s)),
        ("quantize_bf16", lambda: lib.quantize_bf16(*map(ptr, (x0, amax, xq, sx)), B, H * W * 64, s)),
        ("conv12_pool_s8", lambda: lib.conv12_pool_s8(
            *map(ptr, (xq, sx, p.q1, p.sw1, p.b1, pooled, rowmax)), B, H, W, s)),
        ("conv21_s8", lambda: lib.conv21_s8(
            *map(ptr, (pooled, rowmax, p.q2, p.sw2, p.b2, out)), B, H2, W2, r2, s)),
    ]
    return out, [(name, lambda name=name, f=f: native.check(f(), name)) for name, f in steps]


def fused_conv12_pool_conv21_q(x0: torch.Tensor, p: StemParams) -> torch.Tensor:
    """Kernel #7: the w8a8 form of #6 -> ``[B, H/2, W/2, 128]`` bf16, in
    four launches (:func:`int8_launches`): the per-sample ``amax`` and the
    quantization of ``x0`` (which the JAX package runs in XLA before its
    kernel), the int8 conv1_2 + pool into a float32 pooled map with each
    pooled row's max, and the int8 conv2_1, which takes the block scales
    ``s2`` from those maxima and quantizes the pooled map as it loads it."""
    if x0.device.type == "cpu":
        return conv12_pool_conv21_q_plain(x0, p)
    _check("fused_conv12_pool_conv21_q", x0, p, ("q1", "sw1", "b1", "q2", "sw2", "b2"))
    out, steps = int8_launches(x0, p)
    for _, launch in steps:
        launch()
    native.count_launch(fused_conv12_pool_conv21_q)
    return out


fused_stem_conv.launches = 0
fused_conv12_pool.launches = 0
fused_conv12_pool_conv21.launches = 0
fused_conv12_pool_conv21_q.launches = 0
