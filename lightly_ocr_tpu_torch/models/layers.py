"""Shared building blocks of the port's models (NCHW inside).

Module and parameter names follow the reference torch state dict, so the
output of :func:`lightly_ocr_tpu_torch.weights.state_dict_from_variables`
loads with ``strict=True``.

A model computes in its compute dtype (:func:`compute_dtype`) on float32
parameters, as a flax model with ``dtype=`` does: every conv, Linear and
LSTM casts its parameters to the activation's dtype before the product
(:func:`cast_to`), and :class:`BatchNorm2d` reduces in float32 and rounds
once.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from lightly_ocr_tpu_torch.parallel.collectives import all_sum_autograd, is_split


class BatchNorm2d(nn.Module):
    """BatchNorm (eps 1e-5) with the torch parameter names and flax's
    training rule (``lightly_ocr_tpu/models/layers.py::batch_norm``).

    In ``eval()`` it normalises with the running statistics.  In
    ``train()`` it normalises with the batch's statistics over (N, H, W),
    computed in float32, and moves the running statistics by
    ``running = 0.9 * running + 0.1 * batch`` (flax's ``momentum=0.9``)
    with the *biased* batch variance, as flax stores it (``nn.BatchNorm2d``
    stores the unbiased one).  While ``frozen_stats`` is set (a forward
    recomputed for the backward, :func:`frozen_batch_stats`) the running
    statistics stay as they are.

    Unlike ``nn.BatchNorm2d`` it has no ``num_batches_tracked`` buffer: the
    JAX tree has no such leaf, and strict loads of its state dicts stay
    exact.  As flax's ``BatchNorm``, it keeps its parameters in float32
    whatever the compute dtype (:func:`to_serving`), computes in float32
    and rounds once to the input's dtype."""

    momentum = 0.1  # the share of the batch statistics (flax: 1 - 0.9)
    group = None  # the processes whose rows make the batch (sync_batch_norm)

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.frozen_stats = False
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                training=False, eps=self.eps,
            )
        dt = torch.promote_types(x.dtype, torch.float32)  # at least float32, as flax
        if is_split(self.group):
            y, mean, var = self._global_batch_norm(x.to(dt))
        else:
            y, mean, invstd = torch.native_batch_norm(
                x.to(dt), self.weight.to(dt), self.bias.to(dt), None, None, True,
                self.momentum, self.eps)
            var = None
        if not self.frozen_stats:
            with torch.no_grad():
                if var is None:
                    var = (invstd.pow(-2) - self.eps).clamp_min_(0.0)  # biased
                self.running_mean.mul_(1.0 - self.momentum).add_(
                    mean.to(self.running_mean.dtype), alpha=self.momentum)
                self.running_var.mul_(1.0 - self.momentum).add_(
                    var.to(self.running_var.dtype), alpha=self.momentum)
        return y.to(x.dtype)

    def _global_batch_norm(self, x: torch.Tensor):
        """(y, mean, biased var) over the batch of every process in
        ``group``: the per-channel sums of ``x`` and ``x^2`` and the count
        summed across the processes (differentiably), then flax's formula,
        ``mean = E[x]``, ``var = max(E[x^2] - mean^2, 0)``,
        ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias``."""
        C = x.shape[1]
        local = torch.cat([x.sum((0, 2, 3)), (x * x).sum((0, 2, 3)),
                           x.new_full((1,), x.numel() // C)])
        total = all_sum_autograd(local, self.group)
        n = total[2 * C].detach()
        mean = total[:C] / n
        var = (total[C:2 * C] / n - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(x.dtype)
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias.to(x.dtype)[:, None, None]
        return y, mean, var


def sync_batch_norm(module: nn.Module, group) -> nn.Module:
    """Make every :class:`BatchNorm2d` of ``module`` normalise in training
    mode over the batch of all processes of ``group`` (a
    ``torch.distributed`` process group; ``None`` = this process's batch).
    With more than one process the statistics are flax's over the global
    batch (:meth:`BatchNorm2d._global_batch_norm`); with one, the module is
    unchanged."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.group = group
    return module


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module):
    """Hold the running statistics of every :class:`BatchNorm2d` in
    ``module`` while the block runs (a forward recomputed by
    ``torch.utils.checkpoint`` must not count its batch a second time)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.frozen_stats = True
    try:
        yield
    finally:
        for m in norms:
            m.frozen_stats = False


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-12) / 127``, a true float32 division on every device.
    (PyTorch's CUDA kernels multiply by the reciprocal of a Python-number
    divisor, which rounds differently from the division the JAX package
    and the CUDA kernels do.)"""
    a = amax.clamp_min(1e-12)
    return a / torch.full_like(a, 127.0)


def quantize_per_sample(x: torch.Tensor):
    """Symmetric per-sample int8 of ``x`` ``[B, ...]`` (the JAX
    ``QuantConv`` convention): ``sx = max(amax over all but dim 0, 1e-12)
    / 127`` and ``xq = clip(round(x / sx), -127, 127)``, computed in
    float32 with a true division and round-half-to-even.  Returns
    ``(xq int8, sx f32 [B, 1, ..., 1])``."""
    xf = x.float()
    dims = tuple(range(1, xf.ndim))
    sx = int8_scale(xf.abs().amax(dim=dims, keepdim=True))
    return quantize_with(xf, sx), sx


def quantize_with(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / s), -127, 127)`` as int8 (``s`` broadcasts)."""
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def quantize_weight(w: torch.Tensor):
    """Per-out-channel symmetric int8 of a float32 OIHW (or [out, in])
    weight: ``sw = max(amax over all but dim 0, 1e-12) / 127``.  Returns
    ``(wq int8, sw f32 [out])``."""
    w = w.float()
    sw = int8_scale(w.abs().amax(dim=tuple(range(1, w.ndim))))
    return quantize_with(w, sw.view(-1, *([1] * (w.ndim - 1)))), sw


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 ``[M, K] @ [K, N]`` -> int32, exact.  ``torch._int_mm`` on a
    CUDA tensor wants more than 16 rows and K, N multiples of 8: the
    operands are zero-padded to that (zeros add nothing) and the result
    cut back."""
    M, K = a.shape
    N = b.shape[1]
    pm, pk, pn = max(0, 17 - M), -K % 8, -N % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    # mat2 column-major: cuBLASLt's native int8 layout
    out = torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return out[:M, :N] if (pm or pn) else out


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, kernel=(3, 3), stride=(1, 1),
              padding=(0, 0), dilation=(1, 1)) -> torch.Tensor:
    """int8 NHWC ``[B, H, W, C]`` conv int8 ``[kh*kw*C, N]`` (K is
    tap-major, ``(i*kw + j)*C + c``) -> int32 NHWC, every sum exact.

    The kh*kw shifted (strided, dilated) taps of the zero-padded input are
    laid side by side on the channel axis and contracted in one
    :func:`int_mm`: integer arithmetic, so the result equals XLA's int8
    convolution bit for bit on any device."""
    B, H, W, C = xq.shape
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, dilation
    taps = kh * kw
    xp = F.pad(xq, (0, 0, pw, pw, ph, ph))
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    cols = [xp[:, i * dh: i * dh + sh * (Ho - 1) + 1: sh,
               j * dw: j * dw + sw * (Wo - 1) + 1: sw]
            for i in range(kh) for j in range(kw)]
    a = cols[0] if taps == 1 else torch.cat(cols, dim=-1)
    return int_mm(a.reshape(B * Ho * Wo, taps * C), wq).view(B, Ho, Wo, -1)


def tap_major(w: torch.Tensor) -> torch.Tensor:
    """OIHW -> ``[kh*kw*I, O]`` with K tap-major (:func:`int8_conv`)."""
    O, I, kh, kw = w.shape
    return w.permute(2, 3, 1, 0).reshape(kh * kw * I, O).contiguous()


def cast_to(t: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor | None:
    """``t`` in ``x``'s dtype (``None`` stays ``None``): flax's rule for a
    layer's parameters, which are cast to the compute dtype before the
    product.  Parameters already in that dtype (a model moved by
    :func:`to_serving`, or cast with ``.to``) come back as they are, so
    such a model computes exactly as it did without the cast."""
    return None if t is None else t.to(x.dtype)


def compute_dtype(model: nn.Module) -> torch.dtype:
    """The dtype ``model`` computes in: its ``dtype`` while its parameters
    are float32 (master weights, as the JAX package keeps them whatever the
    compute dtype), else its parameters' dtype (``.double()``,
    :func:`to_serving`)."""
    p = next(model.parameters()).dtype
    return model.dtype if p == torch.float32 else p


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on its weight and bias cast to the input's dtype
    (:func:`cast_to`), as flax's ``Conv(dtype=...)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, cast_to(self.weight, x), cast_to(self.bias, x))


class Linear(nn.Linear):
    """``nn.Linear`` on its weight and bias cast to the input's dtype
    (:func:`cast_to`), as flax's ``Dense(dtype=...)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, cast_to(self.weight, x), cast_to(self.bias, x))


class LSTM(nn.LSTM):
    """``nn.LSTM`` on a batched input, its weights cast to the input's
    dtype once a call (:func:`cast_to`).  Weights already in that dtype
    are passed as they are: the call ``nn.LSTM`` makes (cuDNN's flattened
    weights on the card)."""

    def forward(self, x: torch.Tensor, hx=None):
        self._update_flat_weights()
        if hx is None:
            n = self.num_layers * (2 if self.bidirectional else 1)
            h0 = x.new_zeros(n, x.shape[0 if self.batch_first else 1], self.hidden_size)
            hx = (h0, h0)
        out, h, c = torch.lstm(x, hx, [cast_to(w, x) for w in self._flat_weights], self.bias,
                               self.num_layers, self.dropout, self.training,
                               self.bidirectional, self.batch_first)
        return out, (h, c)


class LSTMCell(nn.LSTMCell):
    """``nn.LSTMCell`` whose :meth:`cast` casts its weights once for any
    number of steps (:func:`cast_to`)."""

    def cast(self, x: torch.Tensor):
        """The cell as a function ``(input, (h, c)) -> (h, c)`` on its
        weights in ``x``'s dtype."""
        w = [cast_to(t, x) for t in (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)]

        def cell(inp, hx):
            return torch.lstm_cell(inp, hx, *w)

        return cell


class QuantConv(Conv2d):
    """``nn.Conv2d`` with the JAX package's w8a8 serving mode
    (``lightly_ocr_tpu/models/layers.py::QuantConv``), same parameters.

    With ``quant`` on and ``min(in, out) >= 128`` channels: the weights are
    symmetric per-out-channel int8 from the float32 master, the input
    symmetric per-sample int8, the products int32 sums
    (:func:`int8_conv`), then ``y * (sx * sw) + b`` in float32 and a cast
    to the input's dtype.  Narrower layers, or ``quant`` off, run the
    float convolution of :class:`Conv2d` (the parameters cast to the
    input's dtype).

    The JAX package keeps float32 master parameters whatever the compute
    dtype.  :func:`to_serving` moves a model to its device and dtype and
    has every ``QuantConv`` keep a float32 copy of its weight and bias
    first (:meth:`master`), from which the int8 codes are taken once."""

    def __init__(self, *args, quant: bool = False, **kw):
        super().__init__(*args, **kw)
        self.quant = quant
        self._master = None
        self._codes = None

    @property
    def quantized(self) -> bool:
        return self.quant and min(self.in_channels, self.out_channels) >= 128

    def master(self):
        """(weight, bias) in float32: the copies kept by
        :meth:`keep_master`, else the live parameters upcast."""
        if self._master is not None:
            return self._master
        b = None if self.bias is None else self.bias.detach().float()
        return self.weight.detach().float(), b

    @torch.no_grad()
    def keep_master(self) -> None:
        """Keep float32 copies of the parameters as they are now (and the
        int8 codes taken from them); a later ``.to(dtype)`` leaves them."""
        b = None if self.bias is None else self.bias.detach().float().clone()
        self._master = (self.weight.detach().float().clone(), b)
        self._codes = self._quantized_weight() if self.quantized else None

    def _quantized_weight(self):
        wq, sw = quantize_weight(self.master()[0])
        return tap_major(wq), sw

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.quantized:
            # flax's Conv: the product rounded to the compute dtype, then
            # the bias added in that dtype
            y = self._conv_forward(x, cast_to(self.weight, x), None)
            return y if self.bias is None else y + cast_to(self.bias, x)[:, None, None]
        wq, sw = self._codes if self._codes is not None else self._quantized_weight()
        xq, sx = quantize_per_sample(x.permute(0, 2, 3, 1))  # NHWC
        y = int8_conv(xq, wq, self.kernel_size, self.stride, self.padding, self.dilation)
        out = y.float() * (sx * sw)
        b = self.master()[1]
        if b is not None:
            out = out + b
        return out.to(x.dtype).permute(0, 3, 1, 2)


def to_serving(module: nn.Module, device, dtype, memory_format=torch.contiguous_format):
    """``module.to(device)``, every :class:`QuantConv` keeps its float32
    master (:meth:`QuantConv.keep_master`), then ``.to(dtype)`` for all but
    the :class:`BatchNorm2d` layers, which stay float32."""
    module.to(device)
    for m in module.modules():
        if isinstance(m, QuantConv):
            m.keep_master()
    norms = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    kept = [{k: t.float().clone() for k, t in m.state_dict().items()} for m in norms]
    module.to(dtype).to(memory_format=memory_format)
    for m, state in zip(norms, kept):
        m.float().load_state_dict(state)
    return module


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


@torch.no_grad()
def init_train_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded training initialisation of ``module`` with flax's defaults, as
    ``CRNNet.init`` gives them in the JAX package (not :func:`init_module`'s
    serving-test distributions):

    * convolution and linear weights lecun-normal (a normal of variance
      1/fan_in truncated at two standard deviations, flax's
      ``variance_scaling(1, "fan_in", "truncated_normal")``), biases zero;
    * BatchNorm weight 1, bias 0, running statistics (0, 1);
    * LSTM tensors symmetric U(-1/sqrt(H), 1/sqrt(H)) (torch's rule, which
      the JAX package copies: ``layers.py::torch_rnn_init``);
    * modules marked ``_keep_init`` (the TPS ``localization_fc2``: zero
      weight, the fiducial points as bias, flax's init of that layer) keep
      the values they are built with."""
    # flax divides the std by the std of a unit normal truncated at +-2
    trunc_std = 0.87962566103423978
    for m in module.modules():
        if getattr(m, "_keep_init", False):
            continue
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = math.sqrt(1.0 / m.weight[0].numel()) / trunc_std
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, (nn.LSTM, nn.LSTMCell)):
            k = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters(recurse=False):
                nn.init.uniform_(p, -k, k, generator=generator)
    return module
