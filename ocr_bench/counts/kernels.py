"""Least times of the port's hand kernels from their shapes: operations
and bytes the function needs, over the H100's published peaks (SXM, dense).

Each input byte is counted read once and each output byte written once,
whatever the kernel reads again, so the bound reads the same whatever
implements the function.  The arithmetic is that of the repository's chip
smoke test, copied here so that the yardstick stays fixed.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores (TF32 off)
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


def tail_flops(B: int, H2: int, W2: int) -> int:
    """Kernel #1 (the seam tail): a map pixel's 1x1 128->64 on the skip
    half of upconv4, its 3x3 64->32, and conv_cls (3x3 32->32 twice, 3x3
    32->16, 1x1 16->16, 1x1 16->2)."""
    return 2 * B * H2 * W2 * (128 * 64 + 9 * 64 * 32 + 2 * 9 * 32 * 32 + 9 * 32 * 16 + 16 * 16 + 16 * 2)


def tail_bound_ms(B: int, H2: int, W2: int) -> tuple[float, str]:
    """Kernel #1's least time: the skip half (128 bf16 channels) and the
    lower-resolution projection (64 float32 channels at a quarter of the
    pixels) read once, the two float32 scores written once, the weights."""
    px = B * H2 * W2
    weights = 2 * (128 * 64 + 9 * (64 * 32 + 2 * 32 * 32 + 32 * 16) + 16 * 16 + 32)
    nbytes = px * 128 * 2 + (px // 4) * 64 * 4 + px * 2 * 4 + weights
    t_ops, t_bytes = tail_flops(B, H2, W2) / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def conv12_flops(B: int, H: int, W: int, conv21: bool = False) -> int:
    """conv1_2 (3x3 64->64 at full resolution), and conv2_1 (3x3 64->128 at
    half) where ``conv21``."""
    px = B * H * W
    return 2 * px * 576 * 64 + (2 * (px // 4) * 576 * 128 if conv21 else 0)


def stem_bound_ms(B: int, H: int, W: int, conv21: bool = False, int8: bool = False,
                  pool: bool = True) -> tuple[float, str]:
    """Kernel #5 (``conv21`` False), #6/#7, or #4 (``pool`` False): the
    bf16 input read once, the weights, the bf16 output (pooled, or at full
    resolution for #4) written once."""
    px = B * H * W
    wbytes = (1 if int8 else 2) * 576 * (64 + (128 if conv21 else 0))
    out_px = px // 4 if pool else px
    nbytes = px * 64 * 2 + out_px * (128 if conv21 else 64) * 2 + wbytes
    t_ops = conv12_flops(B, H, W, conv21) / (PEAK_INT8_OPS if int8 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
