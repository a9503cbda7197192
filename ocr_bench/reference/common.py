"""Plain building blocks of the reference models: float32 PyTorch
operations on a state dict with the reference torch key names.

``Precision`` is the arithmetic of the products.  ``Precision()`` is float32
(TF32 must be off, which the caller sets); ``Precision("fp8")`` rounds both
operands of every convolution and linear product to float8 e4m3 with one
scale a tensor (its largest magnitude maps to 448) and multiplies in
float32: the control that computes one step below the configuration's
bfloat16.  BatchNorm, activations, softmax and sums stay float32 in both.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


class Precision:
    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8"):
            raise ValueError(f"unknown reference precision {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the products see it."""
        if self.kind == "float32":
            return x
        scale = x.abs().amax().clamp_min(1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


FP32 = Precision()


def conv(sd: dict, key: str, x: torch.Tensor, p: Precision = FP32, **kw) -> torch.Tensor:
    b = sd.get(key + ".bias")
    return F.conv2d(p(x), p(sd[key + ".weight"]), b, **kw)


def linear(sd: dict, key: str, x: torch.Tensor, p: Precision = FP32) -> torch.Tensor:
    b = sd.get(key + ".bias")
    return F.linear(p(x), p(sd[key + ".weight"]), b)


def bn_eval(sd: dict, key: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm on the running statistics (NCHW)."""
    scale = sd[key + ".weight"] / torch.sqrt(sd[key + ".running_var"] + eps)
    shift = sd[key + ".bias"] - sd[key + ".running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def bn_train(sd: dict, key: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm on the batch's statistics over (N, H, W), the biased
    variance (NCHW); the running statistics are not the reference's
    business."""
    mean = x.mean(dim=(0, 2, 3))
    var = ((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
    y = (x - mean[:, None, None]) / torch.sqrt(var + eps)[:, None, None]
    return y * sd[key + ".weight"][:, None, None] + sd[key + ".bias"][:, None, None]


def lstm_cell(x, h, c, w_ih, w_hh, b_ih, b_hh, p: Precision = FP32):
    """One LSTM step, gates in torch's order (i, f, g, o)."""
    gates = F.linear(p(x), p(w_ih), b_ih) + F.linear(p(h), p(w_hh), b_hh)
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


@contextlib.contextmanager
def float32_exact():
    """TF32 off for cuDNN and matmuls inside the block (the reference's
    float32), the caller's settings back after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
