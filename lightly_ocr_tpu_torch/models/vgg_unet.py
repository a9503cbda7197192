"""CRAFT text detector: VGG16-BN encoder + U-Net decoder (PyTorch).

Port of ``lightly_ocr_tpu/models/vgg_unet.py`` (reference ``ocr/model.py:
9-61`` + ``ocr/modules/vgg_bn.py``).  Modules compute in NCHW; the public
methods take and return NHWC like the JAX package.

* The encoder is torchvision's VGG16-BN ``features`` sliced at indices
  12/19/29/39; slice5 is maxpool(3, s1, p1) + dilated 3x3 conv (rate 6,
  512->1024) + 1x1 conv.
* The decoder concatenates, upsamples (bilinear, half-pixel centres) and
  runs four :class:`UpConv` blocks and the 5-conv ``conv_cls`` head.
* ``quant=True`` is the JAX package's w8a8 serving mode: every backbone and
  decoder conv is a :class:`QuantConv` (int8 at 128 channels and wider);
  the ``conv_cls`` head stays float.  It serves only: ``forward`` refuses it
  in ``train()``.
* In ``train()`` every :class:`BatchNorm2d` normalises with the batch's
  statistics and moves its running ones (flax's rule), as the JAX model
  called with ``train=True``; :func:`~lightly_ocr_tpu_torch.models.layers.
  init_train_params` gives it flax's training initialisation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lightly_ocr_tpu_torch.models.layers import (
    BatchNorm2d,
    QuantConv,
    int8_scale,
    int_mm,
    max_pool,
    quantize_per_sample,
    quantize_with,
)

# Effective dataflow of the reference slices ("C", idx, cin, cout | "P" pool
# | "R" relu).  The reference's slices end on a BatchNorm and the next slice
# starts with an IN-PLACE ReLU, which mutates the saved slice output: slices
# 1-3 are therefore read post-ReLU by the decoder, slice4 pre-ReLU (slice5
# starts with a pool).  Hence the trailing R on slices 1-3 and none on 4.
_VGG_SLICES = {
    "slice1": [("C", 0, 3, 64), ("R",), ("C", 3, 64, 64), ("R",), ("P",),
               ("C", 7, 64, 128), ("R",), ("C", 10, 128, 128), ("R",)],
    "slice2": [("P",), ("C", 14, 128, 256), ("R",), ("C", 17, 256, 256),
               ("R",)],
    "slice3": [("C", 20, 256, 256), ("R",), ("P",), ("C", 24, 256, 512),
               ("R",), ("C", 27, 512, 512), ("R",)],
    "slice4": [("C", 30, 512, 512), ("R",), ("P",), ("C", 34, 512, 512),
               ("R",), ("C", 37, 512, 512)],
}


# slice1 resumed after a fused stem kernel (``vgg_unet.py`` of the JAX
# package): after the full-resolution conv1_2 (``fused_stem_conv``, the JAX
# package's ``_SLICE1_POST``), after conv1_2 + pool (``fused_conv12_pool``),
# and after conv1_2 + pool + conv2_1 (``fused_conv12_pool_conv21[_q]``).  The prefix that feeds
# those kernels is conv1_1 + BN + ReLU (:meth:`VGG_UNet.stem_prefix`).
_SLICE1_PREFIX = _VGG_SLICES["slice1"][:2]
_SLICE1_RESUME = {
    "stem": _VGG_SLICES["slice1"][4:],
    "pool": _VGG_SLICES["slice1"][5:],
    "c21": _VGG_SLICES["slice1"][7:],
}


class _VggSlice(nn.ModuleDict):
    def __init__(self, ops, quant: bool = False):
        layers = {}
        for op in ops:
            if op[0] == "C":
                _, idx, cin, cout = op
                layers[str(idx)] = QuantConv(cin, cout, 3, padding=1, quant=quant)
                layers[str(idx + 1)] = BatchNorm2d(cout)
        super().__init__(layers)
        self.ops = ops

    def forward(self, x, ops=None):
        for op in self.ops if ops is None else ops:
            if op[0] == "R":
                x = F.relu(x)
            elif op[0] == "P":
                x = max_pool(x, 2, 2)
            else:
                idx = op[1]
                x = self[str(idx + 1)](self[str(idx)](x))
        return x


class _Slice5(nn.ModuleDict):
    """fc6/fc7: children named 1/2 as in the torch Sequential (0 = pool)."""

    def __init__(self, quant: bool = False):
        super().__init__({
            "1": QuantConv(512, 1024, 3, padding=6, dilation=6, quant=quant),
            "2": QuantConv(1024, 1024, 1, quant=quant),
        })

    def forward(self, x):
        x = max_pool(x, 3, 1, 1)
        return self["2"](self["1"](x))


class VggBackbone(nn.Module):
    def __init__(self, quant: bool = False):
        super().__init__()
        for name, ops in _VGG_SLICES.items():
            setattr(self, name, _VggSlice(ops, quant))
        self.slice5 = _Slice5(quant)

    def forward(self, x, slice1_ops=None):
        """``slice1_ops`` runs only that tail of slice1 (a resume point)."""
        outs = {}
        for name in _VGG_SLICES:
            x = getattr(self, name)(x, slice1_ops if name == "slice1" else None)
            outs[name] = x
        outs["fc7"] = self.slice5(x)
        return outs


def _upsample_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize, half-pixel centres (``jax.image.resize`` bilinear)."""
    return F.interpolate(
        x, size=(h, w), mode="bilinear", align_corners=False, antialias=False
    )


class UpConv(nn.Module):
    """1x1 conv-BN-ReLU then 3x3 conv-BN-ReLU (``vgg_bn.py:23-31``)."""

    def __init__(self, cin: int, mid: int, out: int, quant: bool = False):
        super().__init__()
        self.conv = nn.ModuleDict({
            "0": QuantConv(cin, mid, 1, quant=quant),
            "1": BatchNorm2d(mid),
            "3": QuantConv(mid, out, 3, padding=1, quant=quant),
            "4": BatchNorm2d(out),
        })

    def _rest(self, x):
        x = F.relu(self.conv["1"](x))
        return F.relu(self.conv["4"](self.conv["3"](x)))

    def forward(self, x):
        return self._rest(self.conv["0"](x))

    def forward_seam(self, y, t):
        """Same block on the PRE-concat pair ``(y, t)``."""
        return self._rest(self.seam_1x1(y, t))

    def seam_1x1(self, y, t):
        """The block's 1x1 on the PRE-concat pair ``(y, t)``:
        ``conv1x1(cat([up(y), t])) == up(conv1x1_a(y)) + conv1x1_b(t)``
        (both linear), so the concat never exists and the y-half runs at
        y's lower resolution.  As the JAX package's ``_Split1x1``: each
        half is a float32 result (float: products of compute-dtype
        operands summed in float32, a float32 ``torch.matmul``; int8: one
        per-out-channel scale over the whole kernel, a per-sample scale for
        each half, int32 sums), the halves and the float32 bias are summed
        in float32 and cast once."""
        c0 = self.conv["0"]
        w, bias = c0.master()
        k = w[:, :, 0, 0].t()  # [cin, mid]
        cy = y.shape[1]
        if c0.quantized:
            sw = int8_scale(k.abs().amax(0))

            def half(x, kk):
                xq, sx = quantize_per_sample(x.permute(0, 2, 3, 1))
                o = int_mm(xq.reshape(-1, xq.shape[-1]), quantize_with(kk, sw))
                return o.view(*xq.shape[:3], -1).float() * (sx * sw)
        else:
            def half(x, kk):
                return torch.matmul(x.permute(0, 2, 3, 1).float(), kk.to(t.dtype).float())

        a = half(y, k[:cy]).permute(0, 3, 1, 2)
        b = half(t, k[cy:]).permute(0, 3, 1, 2)
        if a.shape[-2:] != b.shape[-2:]:
            a = _upsample_to(a, t.shape[2], t.shape[3])
        return (a + b + bias[:, None, None]).to(t.dtype)


class _Head(nn.ModuleDict):
    def __init__(self):
        super().__init__({
            "0": nn.Conv2d(32, 32, 3, padding=1),
            "2": nn.Conv2d(32, 32, 3, padding=1),
            "4": nn.Conv2d(32, 16, 3, padding=1),
            "6": nn.Conv2d(16, 16, 1),
            "8": nn.Conv2d(16, 2, 1),
        })

    def forward(self, x):
        for k in ("0", "2", "4", "6"):
            x = F.relu(self[k](x))
        return self["8"](x)


class VGG_UNet(nn.Module):
    """CRAFT detector graph (``ocr/model.py:9-61``)."""

    def __init__(self, quant: bool = False):
        super().__init__()
        self.quant = quant
        self.basenet = VggBackbone(quant)
        self.upconv1 = UpConv(1024 + 512, 512, 256, quant)
        self.upconv2 = UpConv(256 + 512, 256, 128, quant)
        self.upconv3 = UpConv(128 + 256, 128, 64, quant)
        self.upconv4 = UpConv(64 + 128, 64, 32, quant)
        self.conv_cls = _Head()

    @staticmethod
    def _nchw(x):
        return x.permute(0, 3, 1, 2)

    @staticmethod
    def _nhwc(x):
        return x.permute(0, 2, 3, 1).contiguous()

    def forward(self, x: torch.Tensor):
        """[B, H, W, 3] canvas -> ([B, H/2, W/2, 2] scores, [B, H/2, W/2, 32]
        feature), NHWC, the plain (un-fused) detector."""
        if self.quant and self.training:
            raise ValueError(
                "quant=True is an inference-only mode: QuantConv's rounding "
                "has zero gradient, so training would silently freeze every "
                "backbone conv.  Train in float and enable quant_int8 only "
                "for serving."
            )
        p = next(self.parameters())
        s = self.basenet(self._nchw(x).to(p.dtype))
        y = self.upconv1(torch.cat([s["fc7"], s["slice4"]], 1))
        for up, skip in ((self.upconv2, "slice3"), (self.upconv3, "slice2"),
                         (self.upconv4, "slice1")):
            t = s[skip]
            y = _upsample_to(y, t.shape[2], t.shape[3])
            y = up(torch.cat([y, t], 1))
        return self._nhwc(self.conv_cls(y)), self._nhwc(y)

    def stem_prefix(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] canvas -> conv1_1 + BN + ReLU [B, H, W, 64] NHWC,
        the input of the fused stem kernels (the JAX package's
        ``VggStemPrefix``)."""
        p = next(self.parameters())
        y = self.basenet.slice1(self._nchw(x).to(p.dtype), _SLICE1_PREFIX)
        return self._nhwc(y)

    def trunk(self, x: torch.Tensor, resume: str | None = None):
        """[B, H, W, 3] canvas -> the seam pair ``(upconv3 out [B, H/4, W/4,
        64], slice1 [B, H/2, W/2, 128])`` NHWC, the input of
        :func:`lightly_ocr_tpu_torch.ops.seam_tail.seam_tail` (the JAX
        package's ``VGG_UNetTrunk(seam=True)``).

        ``resume="stem"`` takes instead the conv1_2 activation ``[B, H, W,
        64]`` and resumes at pool1 (``from_stem=True``);
        ``resume="pool"`` takes the conv1_2 + pool activation
        ``[B, H/2, W/2, 64]`` and resumes at conv2_1 (``from_pool=True``);
        ``resume="c21"`` takes the conv2_1 activation ``[B, H/2, W/2, 128]``
        and resumes at conv2_2 (``from_c21=True``)."""
        p = next(self.parameters())
        ops = None if resume is None else _SLICE1_RESUME[resume]
        s = self.basenet(self._nchw(x).to(p.dtype), ops)
        y = self.upconv1.forward_seam(s["fc7"], s["slice4"])
        y = self.upconv2.forward_seam(y, s["slice3"])
        y = self.upconv3.forward_seam(y, s["slice2"])
        return self._nhwc(y), self._nhwc(s["slice1"])
