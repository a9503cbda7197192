"""RARE thin-plate-spline rectifier (TPS-STN), PyTorch port.

Port of ``lightly_ocr_tpu/models/tps.py`` (reference ``ocr/modules/
TPS_STN.py:10-150``): a localization network predicts F fiducial points, the
TPS system maps them to a sampling grid, and the crop is resampled
bilinearly (border padding, ``align_corners=True``) by
:func:`lightly_ocr_tpu_torch.ops.grid_sample.grid_sample`, the semantics of
``lightly_ocr_tpu/ops/grid_sample.py``: the continuous coordinate is
clamped to the image before interpolation, and coordinates and weights are
float32 whatever the crop's dtype (the grid is rounded to that dtype
first, as in the JAX module); the result is rounded to the crop's dtype.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightly_ocr_tpu_torch.models.layers import BatchNorm2d, Conv2d, Linear, max_pool
from lightly_ocr_tpu_torch.ops.grid_sample import grid_sample


@functools.lru_cache(maxsize=8)
def tps_constants(F_: int, out_h: int, out_w: int, eps: float = 1e-6):
    """(inv_delta_C [F+3, F+3], P_hat [out_h*out_w, F+3]) float32 numpy."""
    half = F_ // 2
    cx = np.linspace(-1.0, 1.0, half)
    C = np.concatenate([
        np.stack([cx, -np.ones(half)], axis=1),
        np.stack([cx, np.ones(half)], axis=1),
    ], axis=0)  # [F, 2] fiducial base points: top row, then bottom row
    d = np.linalg.norm(C[:, None, :] - C[None, :, :], axis=2)
    np.fill_diagonal(d, 1.0)
    rbf = (d**2) * np.log(d)
    delta_C = np.zeros((F_ + 3, F_ + 3))
    delta_C[:F_, 0] = 1.0
    delta_C[:F_, 1:3] = C
    delta_C[:F_, 3:] = rbf
    delta_C[F_:F_ + 2, 3:] = C.T
    delta_C[F_ + 2, 3:] = 1.0
    inv_delta_C = np.linalg.inv(delta_C)

    gx = (np.arange(-out_w, out_w, 2) + 1.0) / out_w
    gy = (np.arange(-out_h, out_h, 2) + 1.0) / out_h
    P = np.stack(np.meshgrid(gx, gy), axis=2).reshape(-1, 2)  # pixel centres
    dist = np.linalg.norm(P[:, None, :] - C[None, :, :], axis=2)
    rbf_p = (dist**2) * np.log(dist + eps)
    P_hat = np.concatenate([np.ones((P.shape[0], 1)), P, rbf_p], axis=1)
    return inv_delta_C.astype(np.float32), P_hat.astype(np.float32)


def fiducial_bias_init(F_: int) -> np.ndarray:
    """Initial fiducials: top edge y in [0, -1], bottom y in [1, 0]."""
    half = F_ // 2
    cx = np.linspace(-1.0, 1.0, half)
    top = np.stack([cx, np.linspace(0.0, -1.0, half)], axis=1)
    bot = np.stack([cx, np.linspace(1.0, 0.0, half)], axis=1)
    return np.concatenate([top, bot], axis=0).reshape(-1).astype(np.float32)


# the localization network's conv units: (conv, BatchNorm) names, channels
_UNITS = (("0", "1", 64), ("4", "5", 128), ("8", "9", 256), ("12", "13", 512))


class LocalizationNetwork(nn.Module):
    def __init__(self, F_: int, in_ch: int):
        super().__init__()
        self.F = F_
        layers = {}
        cin = in_ch
        for ci, bi, ch in _UNITS:
            layers[ci] = Conv2d(cin, ch, 3, padding=1, bias=False)
            layers[bi] = BatchNorm2d(ch)
            cin = ch
        self.conv = nn.ModuleDict(layers)
        self.localization_fc1 = nn.ModuleDict({"0": Linear(512, 256)})
        self.localization_fc2 = Linear(256, 2 * F_)
        # RARE Fig. 6a: zero weights + fiducial bias = identity-like warp
        self.localization_fc2._keep_init = True
        with torch.no_grad():
            self.localization_fc2.weight.zero_()
            self.localization_fc2.bias.copy_(torch.from_numpy(fiducial_bias_init(F_)))

    def unit(self, i: int, x):
        """Conv unit ``i`` (0-3): conv, BatchNorm, ReLU, 2x2 max pool."""
        ci, bi, _ = _UNITS[i]
        return max_pool(F.relu(self.conv[bi](self.conv[ci](x))), 2, 2)

    def head(self, x):
        """[B, 512, h, w] features -> [B, F, 2] fiducial points."""
        x = F.relu(self.localization_fc1["0"](x.mean(dim=(2, 3))))
        return self.localization_fc2(x).view(x.shape[0], self.F, 2)

    def forward(self, x):
        for i in range(len(_UNITS)):
            x = self.unit(i, x)
        return self.head(x)


class TPS_STN(nn.Module):
    def __init__(self, F_: int = 20, out_h: int = 32, out_w: int = 100,
                 in_ch: int = 1):
        super().__init__()
        self.out_h, self.out_w = out_h, out_w
        self.LocalizationNetwork = LocalizationNetwork(F_, in_ch)
        # float32 whatever the module's dtype (not buffers: .to(bf16) would
        # round them); one copy per device
        self._consts: dict = {}
        self._F = F_

    def _constants(self, device):
        c = self._consts.get(device)
        if c is None:
            c = tuple(torch.from_numpy(a).to(device)
                      for a in tps_constants(self._F, self.out_h, self.out_w))
            self._consts[device] = c
        return c

    def forward(self, x):
        """[B, C, H, W] -> [B, C, out_h, out_w] rectified."""
        B = x.shape[0]
        c_prime = self.LocalizationNetwork(x).float()
        cp = torch.cat([c_prime, c_prime.new_zeros(B, 3, 2)], 1)  # [B, F+3, 2]
        inv_delta_C, P_hat = self._constants(x.device)
        T = torch.matmul(inv_delta_C, cp)
        P_prime = torch.matmul(P_hat, T)  # [B, n, 2]
        grid = P_prime.view(B, self.out_h, self.out_w, 2).to(x.dtype)
        out = grid_sample(x.permute(0, 2, 3, 1), grid, padding_mode="border", align_corners=True)
        return out.permute(0, 3, 1, 2).to(x.dtype)
