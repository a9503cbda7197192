"""Shared building blocks of the port's models (NCHW inside, float only).

Module and parameter names follow the reference torch state dict, so the
output of :func:`lightly_ocr_tpu_torch.weights.state_dict_from_variables`
loads with ``strict=True``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.Module):
    """Inference BatchNorm (eps 1e-5) with the torch parameter names.

    Unlike ``nn.BatchNorm2d`` it has no ``num_batches_tracked`` buffer: the
    port never trains, and the JAX tree has no such leaf."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            training=False, eps=self.eps,
        )


def max_pool(x: torch.Tensor, kernel, stride, padding=0) -> torch.Tensor:
    """torch ``MaxPool2d`` (pads with -inf), the JAX package's ``max_pool``."""
    return F.max_pool2d(x, kernel, stride, padding)


@torch.no_grad()
def init_module(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights for every layer of ``module``.

    Convolutions and linear layers get He-normal weights (variance 2/fan_in,
    so random activations stay O(1) through the VGG's depth) and small
    biases; BatchNorm gets scales near 1 and running statistics near
    (0, 1); LSTM tensors get torch's U(-1/sqrt(H), 1/sqrt(H)).  Parameters
    marked ``_keep_init`` (the TPS fiducial head) keep their own values."""
    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    def uniform(shape, k):
        return (torch.rand(shape, generator=generator) * 2 - 1) * k

    for m in module.modules():
        if getattr(m, "_keep_init", False):
            continue
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(normal(m.weight.shape, math.sqrt(2.0 / fan_in)))
            if m.bias is not None:
                m.bias.copy_(normal(m.bias.shape, 0.05))
        elif isinstance(m, BatchNorm2d):
            n = m.weight.shape
            m.weight.copy_(1.0 + uniform(n, 0.2))
            m.bias.copy_(uniform(n, 0.1))
            m.running_mean.copy_(uniform(n, 0.1))
            m.running_var.copy_(1.0 + uniform(n, 0.2))
        elif isinstance(m, (nn.LSTM, nn.LSTMCell)):
            k = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters(recurse=False):
                p.copy_(uniform(p.shape, k))
    return module
