"""Seeded random weights, made on the device in two random calls.

Every tensor of a state dict spec (``reference.*.param_spec``) is a view of
one normal or one uniform draw from a ``torch.Generator`` on the device,
scaled by its kind: convolution and linear weights He-normal (variance
2 / fan-in, so activations stay O(1) through the VGG's depth), biases
N(0, 0.05^2), BatchNorm scales 1 +- 0.2, shifts and running means +- 0.1,
running variances 1 +- 0.2, LSTM tensors U(-1/sqrt(H), 1/sqrt(H)); the
TPS head's last layer starts at zero weights and RARE's fiducials.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NORMAL = {"he", "bias"}
UNIFORM = {"bn_weight", "bn_bias", "bn_mean", "bn_var", "lstm"}


def make(spec: list, seed: int, device, fiducials=None) -> dict:
    """{key: float32 tensor on ``device``} for ``spec`` [(key, shape, kind)]."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {k: math.prod(shape) for k, shape, _ in spec}
    n_norm = sum(sizes[k] for k, _, kind in spec if kind in NORMAL)
    n_unif = sum(sizes[k] for k, _, kind in spec if kind in UNIFORM)
    normal = torch.randn(n_norm, generator=g, device=device)
    uniform = torch.rand(n_unif, generator=g, device=device) * 2.0 - 1.0
    out, i, j = {}, 0, 0
    for key, shape, kind in spec:
        n = sizes[key]
        if kind in NORMAL:
            t = normal[i:i + n].view(shape)
            i += n
            t = t * (math.sqrt(2.0 / math.prod(shape[1:])) if kind == "he" else 0.05)
        elif kind in UNIFORM:
            t = uniform[j:j + n].view(shape)
            j += n
            if kind == "lstm":
                t = t * (1.0 / math.sqrt(shape[0] // 4))
            else:
                t = {"bn_weight": 1.0 + 0.2 * t, "bn_bias": 0.1 * t, "bn_mean": 0.1 * t,
                     "bn_var": 1.0 + 0.2 * t}[kind]
        elif kind == "zeros":
            t = torch.zeros(shape, device=device)
        elif kind == "fiducials":
            t = torch.as_tensor(np.asarray(fiducials, np.float32), device=device).view(shape)
        else:
            raise ValueError(f"unknown weight kind {kind!r} of {key}")
        out[key] = t.contiguous()
    return out
