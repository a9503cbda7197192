"""CRAFT (Baek et al., CVPR 2019; github.com/clovaai/CRAFT-pytorch), plain
PyTorch in float32 on a state dict with CRAFT-pytorch's key names.

VGG16-BN ``features`` sliced at 12/19/29/39 (slice4 ends on a BatchNorm,
no ReLU), slice5 = maxpool(3, 1, 1) + 3x3 conv dilated 6 (512 -> 1024) +
1x1 conv, four U-Net ``double_conv`` blocks (1x1 conv-BN-ReLU, 3x3
conv-BN-ReLU) on the concatenation of the bilinearly upsampled
(``align_corners=False``) deeper output with the skip, and the ``conv_cls``
head (3x3 32, 3x3 32, 3x3 16, 1x1 16, 1x1 2, ReLU between).  The maps come
out at half the canvas's resolution: channel 0 region, channel 1 affinity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ocr_bench.reference.common import FP32, Precision, bn_eval, conv

# (kind, conv index, in, out) of torchvision's vgg16_bn.features, by slice
VGG = {
    "slice1": [("C", 0, 3, 64), ("R",), ("C", 3, 64, 64), ("R",), ("P",),
               ("C", 7, 64, 128), ("R",), ("C", 10, 128, 128), ("R",)],
    "slice2": [("P",), ("C", 14, 128, 256), ("R",), ("C", 17, 256, 256), ("R",)],
    "slice3": [("C", 20, 256, 256), ("R",), ("P",), ("C", 24, 256, 512), ("R",),
               ("C", 27, 512, 512), ("R",)],
    "slice4": [("C", 30, 512, 512), ("R",), ("P",), ("C", 34, 512, 512), ("R",),
               ("C", 37, 512, 512)],
}
UPCONVS = {"upconv1": (1024 + 512, 512, 256), "upconv2": (256 + 512, 256, 128),
           "upconv3": (128 + 256, 128, 64), "upconv4": (64 + 128, 64, 32)}
HEAD = [("0", 32, 32, 3), ("2", 32, 32, 3), ("4", 32, 16, 3), ("6", 16, 16, 1), ("8", 16, 2, 1)]


def _conv_spec(key, cin, cout, k, bias=True):
    out = [(key + ".weight", (cout, cin, k, k), "he")]
    return out + ([(key + ".bias", (cout,), "bias")] if bias else [])


def _bn_spec(key, n):
    return [(key + ".weight", (n,), "bn_weight"), (key + ".bias", (n,), "bn_bias"),
            (key + ".running_mean", (n,), "bn_mean"), (key + ".running_var", (n,), "bn_var")]


def param_spec() -> list:
    """[(key, shape, kind)] of every tensor of the detector's state dict."""
    spec = []
    for name, ops in VGG.items():
        for op in ops:
            if op[0] == "C":
                _, i, cin, cout = op
                spec += _conv_spec(f"basenet.{name}.{i}", cin, cout, 3)
                spec += _bn_spec(f"basenet.{name}.{i + 1}", cout)
    spec += _conv_spec("basenet.slice5.1", 512, 1024, 3)
    spec += _conv_spec("basenet.slice5.2", 1024, 1024, 1)
    for name, (cin, mid, out) in UPCONVS.items():
        spec += _conv_spec(f"{name}.conv.0", cin, mid, 1) + _bn_spec(f"{name}.conv.1", mid)
        spec += _conv_spec(f"{name}.conv.3", mid, out, 3) + _bn_spec(f"{name}.conv.4", out)
    for i, cin, cout, k in HEAD:
        spec += _conv_spec(f"conv_cls.{i}", cin, cout, k)
    return spec


def _slice(sd, name, x, p):
    for op in VGG[name]:
        if op[0] == "R":
            x = F.relu(x)
        elif op[0] == "P":
            x = F.max_pool2d(x, 2, 2)
        else:
            key = f"basenet.{name}.{op[1]}"
            x = bn_eval(sd, f"basenet.{name}.{op[1] + 1}", conv(sd, key, x, p, padding=1))
    return x


def _upconv(sd, name, x, p):
    x = F.relu(bn_eval(sd, f"{name}.conv.1", conv(sd, f"{name}.conv.0", x, p)))
    return F.relu(bn_eval(sd, f"{name}.conv.4", conv(sd, f"{name}.conv.3", x, p, padding=1)))


def forward(sd: dict, canvas: torch.Tensor, p: Precision = FP32) -> torch.Tensor:
    """[B, H, W, 3] normalized canvas -> [B, H/2, W/2, 2] scores."""
    y = conv(sd, "conv_cls.8", head_input(sd, canvas, p), p)
    return y.permute(0, 2, 3, 1)


def head_input(sd: dict, canvas: torch.Tensor, p: Precision = FP32) -> torch.Tensor:
    """The 16 channels [B, 16, H/2, W/2] that the last 1x1 conv maps to
    the scores."""
    x = canvas.permute(0, 3, 1, 2).float()
    s = {}
    for name in VGG:
        x = _slice(sd, name, x, p)
        s[name] = x
    fc = F.max_pool2d(x, 3, 1, 1)
    fc = conv(sd, "basenet.slice5.1", fc, p, padding=6, dilation=6)
    fc = conv(sd, "basenet.slice5.2", fc, p)
    y = _upconv(sd, "upconv1", torch.cat([fc, s["slice4"]], 1), p)
    for name, skip in (("upconv2", "slice3"), ("upconv3", "slice2"), ("upconv4", "slice1")):
        t = s[skip]
        y = F.interpolate(y, size=t.shape[2:], mode="bilinear", align_corners=False)
        y = _upconv(sd, name, torch.cat([y, t], 1), p)
    for i, _, _, k in HEAD[:-1]:
        y = F.relu(conv(sd, f"conv_cls.{i}", y, p, padding=k // 2))
    return y
