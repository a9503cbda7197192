"""The kernels' analytic operation counts equal FlopCounterMode's count of
the same work on the plain reference, at a tiny shape."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from ocr_bench.counts import kernels
from ocr_bench.reference import craft
from ocr_bench.reference.common import conv


def det_weights():
    g = torch.Generator().manual_seed(0)
    return {k: torch.randn(s, generator=g) for k, s, _ in craft.param_spec()}


def test_seam_tail_flops_match_the_reference():
    sd = det_weights()
    B, H2, W2 = 2, 6, 10
    t = torch.randn(B, 128, H2, W2)
    w0 = sd["upconv4.conv.0.weight"][:, 64:]  # the 1x1's skip half (the other half runs at the lower resolution)
    with FlopCounterMode(display=False) as fc:
        y = torch.nn.functional.conv2d(t, w0)
        y = conv(sd, "upconv4.conv.3", y, padding=1)
        for i, _, _, k in craft.HEAD:
            y = conv(sd, f"conv_cls.{i}", y, padding=k // 2)
    assert fc.get_total_flops() == kernels.tail_flops(B, H2, W2)


def test_conv12_flops_match_the_reference():
    sd = det_weights()
    B, H, W = 2, 8, 12
    x = torch.randn(B, 64, H, W)
    with FlopCounterMode(display=False) as fc:
        conv(sd, "basenet.slice1.3", x, padding=1)
    assert fc.get_total_flops() == kernels.conv12_flops(B, H, W)
    ms, by = kernels.stem_bound_ms(16, 960, 640)
    assert by == "operations" and 0.7 < ms < 0.75  # the kernel table's 0.733 ms
    ms, by = kernels.tail_bound_ms(16, 480, 320)
    assert by == "operations" and 0.24 < ms < 0.26  # and 0.248 ms
