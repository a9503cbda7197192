"""FAN-style ResNet feature extractor (PyTorch port of ``models/resnet.py``).

Reference ``ocr/modules/resnet50v1.py:5-135``: two 3x3 stem convs, four
BasicBlock stages [1, 2, 5, 3], inter-stage convs and the asymmetric
pool/stride (2, 1) with width padding that turns a 32x100 crop into a
[1 x 26] feature row.  Parameter names follow ``FeatureExtraction.ConvNet.*``.
With ``quant=True`` every conv is a :class:`QuantConv` (w8a8 at 128 channels
and wider), as in the JAX package.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from lightly_ocr_tpu_torch.models.layers import BatchNorm2d, QuantConv, max_pool


def _conv3(cin, cout, quant):
    return QuantConv(cin, cout, 3, padding=1, bias=False, quant=quant)


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, quant: bool = False):
        super().__init__()
        self.conv1 = _conv3(inplanes, planes, quant)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv3(planes, planes, quant)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if inplanes != planes:
            self.downsample = nn.ModuleDict({
                "0": QuantConv(inplanes, planes, 1, bias=False, quant=quant),
                "1": BatchNorm2d(planes),
            })

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = x if self.downsample is None else self.downsample["1"](self.downsample["0"](x))
        return F.relu(y + res)


def _stage(inplanes, planes, blocks, quant):
    return nn.Sequential(
        BasicBlock(inplanes, planes, quant),
        *[BasicBlock(planes, planes, quant) for _ in range(blocks - 1)],
    )


class ResNetFeatures(nn.Module):
    def __init__(self, in_ch: int, oc: int = 512, layers=(1, 2, 5, 3),
                 quant: bool = False):
        super().__init__()
        blocks = [oc // 4, oc // 2, oc, oc]
        self.conv0_1 = _conv3(in_ch, oc // 16, quant)
        self.bn0_1 = BatchNorm2d(oc // 16)
        self.conv0_2 = _conv3(oc // 16, oc // 8, quant)
        self.bn0_2 = BatchNorm2d(oc // 8)
        self.layer1 = _stage(oc // 8, blocks[0], layers[0], quant)
        self.conv1 = _conv3(blocks[0], blocks[0], quant)
        self.bn1 = BatchNorm2d(blocks[0])
        self.layer2 = _stage(blocks[0], blocks[1], layers[1], quant)
        self.conv2 = _conv3(blocks[1], blocks[1], quant)
        self.bn2 = BatchNorm2d(blocks[1])
        self.layer3 = _stage(blocks[1], blocks[2], layers[2], quant)
        self.conv3 = _conv3(blocks[2], blocks[2], quant)
        self.bn3 = BatchNorm2d(blocks[2])
        self.layer4 = _stage(blocks[2], blocks[3], layers[3], quant)
        self.conv4_1 = QuantConv(blocks[3], blocks[3], 2, stride=(2, 1), padding=(0, 1), bias=False,
                                 quant=quant)
        self.bn4_1 = BatchNorm2d(blocks[3])
        self.conv4_2 = QuantConv(blocks[3], blocks[3], 2, stride=1, padding=0, bias=False, quant=quant)
        self.bn4_2 = BatchNorm2d(blocks[3])

    def forward(self, x):
        x = F.relu(self.bn0_1(self.conv0_1(x)))
        x = F.relu(self.bn0_2(self.conv0_2(x)))
        x = self.layer1(max_pool(x, 2, 2))
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.layer2(max_pool(x, 2, 2))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.layer3(max_pool(x, 2, (2, 1), (0, 1)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = self.layer4(x)
        x = F.relu(self.bn4_1(self.conv4_1(x)))
        return F.relu(self.bn4_2(self.conv4_2(x)))  # [B, C, 1, W'] for 32-high crops


class ResNet50v2(nn.Module):
    """Wrapper of the reference class of the same name (``ConvNet.*``)."""

    def __init__(self, in_ch: int, output_channel: int = 512, quant: bool = False):
        super().__init__()
        self.ConvNet = ResNetFeatures(in_ch, output_channel, quant=quant)

    def forward(self, x):
        return self.ConvNet(x)
