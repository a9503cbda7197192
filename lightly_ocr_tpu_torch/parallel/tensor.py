"""Tensor parallelism over a model axis (the JAX package's GSPMD sharding
by ``param_sharding_rules``, ``lightly_ocr_tpu/parallel/mesh.py:65-116``).

:func:`shard_module` keeps, on each rank of the model group, its ``1/model``
slice (along dimension 0) of every tensor that
:func:`~lightly_ocr_tpu_torch.parallel.mesh.param_sharding_rules` splits, and
replaces the layers that hold them:

* ``nn.Conv2d`` and ``nn.Linear`` (so :class:`~lightly_ocr_tpu_torch.models.
  layers.QuantConv` in float) become column-parallel layers:
  ``gather_from_model(op(copy_to_model(x), w_slice)) + bias``.  The bias
  stays replicated and is added after the gather, so that a replicated
  parameter gets the same gradient on every rank;
* ``nn.LSTM`` and ``nn.LSTMCell`` keep their gate-sharded ``weight_ih*`` /
  ``weight_hh*`` as slices, gather them once a call (in one collective) and
  run the stock op on the full weights, the layout GSPMD takes where it
  gathers a weight rather than an activation.  A decode loop gathers the
  cell's weights once, before its steps (:meth:`ShardedLSTMCell.gathered`).
  The gathered weights are fresh tensors, so cuDNN compacts them on each
  call; ``flatten_parameters`` does not apply.

Activations are gathered right after each sharded op, so BatchNorm, the
activations and the losses see the full tensors on every rank.  Module
names and state-dict keys stay the reference names; only the sharded
tensors' shapes are slices.  :func:`full_state_dict`,
:func:`shard_state_dict` and their optimizer counterparts move between the
sharded layout and the full one that checkpoints hold.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from lightly_ocr_tpu_torch.parallel.collectives import (
    copy_to_model,
    gather_along,
    gather_from_model,
    slice_along,
)
from lightly_ocr_tpu_torch.parallel.mesh import param_sharding_rules


def _slice_param(p: nn.Parameter | None, dim: int | None, groups) -> nn.Parameter | None:
    if p is None:
        return None
    t = p.detach() if dim is None else slice_along(p.detach(), dim, groups)
    return nn.Parameter(t.clone(), requires_grad=p.requires_grad)


def gather_weights(weights: list[torch.Tensor], groups) -> list[torch.Tensor]:
    """The full tensors of dim-0 slices ``weights``, in one collective
    (their flat concatenation gathered; the backward takes this rank's
    slices)."""
    m = groups.model_size
    flat = torch.cat([w.reshape(-1) for w in weights])
    full = gather_from_model(flat, 0, groups).view(m, -1)
    out, off = [], 0
    for w in weights:
        n = w.numel()
        out.append(full[:, off:off + n].reshape(m * w.shape[0], *w.shape[1:]))
        off += n
    return out


class ColumnParallelConv2d(nn.Module):
    """A ``Conv2d`` whose output channels are split over the model group:
    this rank's ``weight`` is ``[out/model, in, kh, kw]``, ``bias`` the
    whole ``[out]``."""

    def __init__(self, conv: nn.Conv2d, groups):
        super().__init__()
        if conv.groups != 1 or conv.padding_mode != "zeros" or getattr(conv, "quantized", False):
            raise ValueError(f"cannot shard {conv}: a float, ungrouped, zero-padded conv only")
        self.mesh_groups = groups
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation
        self.weight = _slice_param(conv.weight, 0, groups)
        self.bias = _slice_param(conv.bias, None, groups)

    def forward(self, x):
        g = self.mesh_groups
        y = F.conv2d(copy_to_model(x, g), self.weight, None, self.stride, self.padding, self.dilation)
        y = gather_from_model(y, 1, g)
        return y if self.bias is None else y + self.bias[:, None, None]


class ColumnParallelLinear(nn.Module):
    """A ``Linear`` whose outputs are split over the model group: this
    rank's ``weight`` is ``[out/model, in]``, ``bias`` the whole ``[out]``."""

    def __init__(self, linear: nn.Linear, groups):
        super().__init__()
        self.mesh_groups = groups
        self.weight = _slice_param(linear.weight, 0, groups)
        self.bias = _slice_param(linear.bias, None, groups)

    def forward(self, x):
        y = gather_from_model(F.linear(copy_to_model(x, self.mesh_groups), self.weight), -1,
                              self.mesh_groups)
        return y if self.bias is None else y + self.bias


class _GatheredWeights(nn.Module):
    """Base of the recurrent layers: ``names`` in the stock module's order,
    those in ``sharded`` held as this rank's slices."""

    def __init__(self, module: nn.Module, names: list[str], dims: Mapping[str, int | None], groups):
        super().__init__()
        self.mesh_groups = groups
        self.names = names
        self.sharded = [n for n in names if dims.get(n) == 0]
        for n in names:
            self.register_parameter(n, _slice_param(getattr(module, n), dims.get(n), groups))

    def full_weights(self) -> dict[str, torch.Tensor]:
        """Every parameter by name, the sharded ones gathered."""
        out = {n: getattr(self, n) for n in self.names}
        if self.sharded:
            out.update(zip(self.sharded, gather_weights([out[n] for n in self.sharded],
                                                        self.mesh_groups)))
        return out


class ShardedLSTM(_GatheredWeights):
    """``nn.LSTM`` (no projection) with gate-sharded weights: ``forward``
    gathers them and runs ``torch.lstm`` as ``nn.LSTM`` does."""

    def __init__(self, lstm: nn.LSTM, dims: Mapping[str, int | None], groups):
        if lstm.proj_size:
            raise ValueError("cannot shard an LSTM with a projection")
        super().__init__(lstm, list(lstm._flat_weights_names), dims, groups)
        for k in ("input_size", "hidden_size", "num_layers", "bias", "batch_first", "dropout",
                  "bidirectional"):
            setattr(self, k, getattr(lstm, k))

    def forward(self, x, hx=None):
        full = self.full_weights()
        if hx is None:
            n = self.num_layers * (2 if self.bidirectional else 1)
            h0 = x.new_zeros(n, x.shape[0 if self.batch_first else 1], self.hidden_size)
            hx = (h0, h0)
        out, h, c = torch.lstm(x, hx, [full[n] for n in self.names], self.bias, self.num_layers,
                               self.dropout, self.training, self.bidirectional, self.batch_first)
        return out, (h, c)


class ShardedLSTMCell(_GatheredWeights):
    """``nn.LSTMCell`` with gate-sharded weights.  :meth:`gathered` is the
    cell as a function on the full weights, gathered once for any number
    of steps."""

    def __init__(self, cell: nn.LSTMCell, dims: Mapping[str, int | None], groups):
        super().__init__(cell, ["weight_ih", "weight_hh", "bias_ih", "bias_hh"], dims, groups)

    def gathered(self):
        w = self.full_weights()

        def cell(x, hx):
            return torch.lstm_cell(x, hx, w["weight_ih"], w["weight_hh"], w["bias_ih"], w["bias_hh"])

        return cell

    def forward(self, x, hx):
        return self.gathered()(x, hx)


def shard_module(module: nn.Module, groups) -> nn.Module:
    """Shard ``module`` in place over the model group of ``groups`` (a
    :class:`~lightly_ocr_tpu_torch.parallel.mesh.MeshGroups`) by
    :func:`param_sharding_rules`, and return it.  Call it after the
    module's weights, device and dtype are set, and before its optimizer is
    made.  With one model rank the module is returned as it is.  Every
    rank must hold the same full weights."""
    if groups is None or groups.model_size == 1:
        return module
    rules = param_sharding_rules(module.state_dict(), groups)
    done = set()
    for name, m in list(module.named_modules()):
        prefix = f"{name}." if name else ""
        dims = {k: rules[prefix + k] for k, _ in m.named_parameters(recurse=False)}
        if not any(d is not None for d in dims.values()):
            continue
        if isinstance(m, nn.LSTM):
            new = ShardedLSTM(m, dims, groups)
        elif isinstance(m, nn.LSTMCell):
            new = ShardedLSTMCell(m, dims, groups)
        elif isinstance(m, nn.Conv2d):
            new = ColumnParallelConv2d(m, groups)
        elif isinstance(m, nn.Linear):
            new = ColumnParallelLinear(m, groups)
        else:
            raise ValueError(f"{name} ({type(m).__name__}): no sharded counterpart")
        parent, _, leaf = name.rpartition(".")
        module.get_submodule(parent)._modules[leaf] = new
        done.update(prefix + k for k, d in dims.items() if d is not None)
    module.model_shards = {k: d for k, d in rules.items() if d is not None}
    module.mesh_groups = groups
    assert done == set(module.model_shards), set(module.model_shards) ^ done
    return module


def model_shards(module: nn.Module) -> dict[str, int]:
    """``{name: dim}`` of the tensors that :func:`shard_module` split
    (empty for a module it did not shard)."""
    return getattr(module, "model_shards", {})


def sharded_mask(module: nn.Module) -> list[bool]:
    """For each of ``module.parameters()``: whether it is a slice."""
    shards = model_shards(module)
    return [n in shards for n, _ in module.named_parameters()]


@torch.no_grad()
def full_state_dict(module: nn.Module) -> dict[str, torch.Tensor]:
    """``module.state_dict()`` with every slice gathered (a collective over
    the model group of a sharded module): the one-process state dict."""
    sd = module.state_dict()
    shards = model_shards(module)
    return {k: gather_along(v, shards[k], module.mesh_groups) if k in shards else v
            for k, v in sd.items()}


def shard_state_dict(module: nn.Module, full: Mapping[str, torch.Tensor]) -> dict:
    """A full state dict cut to this rank's slices of ``module``'s sharded
    tensors (``full`` itself for a module that is not sharded)."""
    shards = model_shards(module)
    if not shards:
        return dict(full)
    return {k: slice_along(v, shards[k], module.mesh_groups) if k in shards else v
            for k, v in full.items()}


def _optimizer_dims(optimizer: torch.optim.Optimizer, module: nn.Module) -> dict[int, int]:
    """``{index in the optimizer's state dict: dim}`` of its sharded
    parameters (the indices ``state_dict()`` gives, in its param groups'
    order)."""
    shards = model_shards(module)
    by_id = {id(p): shards.get(n) for n, p in module.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: by_id[id(p)] for i, p in enumerate(params) if by_id.get(id(p)) is not None}


def _map_state(sd: dict, dims: dict[int, int], fn) -> dict:
    state = {i: {k: fn(v, dims[i]) if i in dims and torch.is_tensor(v) and v.ndim else v
                 for k, v in s.items()}
             for i, s in sd["state"].items()}
    return {**sd, "state": state}


@torch.no_grad()
def full_optimizer_state(optimizer: torch.optim.Optimizer, module: nn.Module) -> dict:
    """``optimizer.state_dict()`` with the state of every sharded parameter
    gathered (a collective over the model group): the one-process one."""
    sd = optimizer.state_dict()
    if not model_shards(module):
        return sd
    groups = module.mesh_groups
    return _map_state(sd, _optimizer_dims(optimizer, module),
                      lambda v, d: gather_along(v, d, groups))


def shard_optimizer_state(optimizer: torch.optim.Optimizer, module: nn.Module, full: dict) -> dict:
    """A full optimizer state dict cut to this rank's slices."""
    if not model_shards(module):
        return full
    groups = module.mesh_groups
    return _map_state(full, _optimizer_dims(optimizer, module),
                      lambda v, d: slice_along(v, d, groups))
