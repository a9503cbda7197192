"""Operations of one CRAFT training sample, counted once by
``FlopCounterMode`` on the plain reference (``reference/craft_train.py``)
on meta tensors: the forward in training mode, the OHEM-MSE of both maps
and the backward, so that an MFU reads the same whatever implements the
step."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ocr_bench.reference import craft, craft_train


def train_per_sample(height: int, width: int, batch: int = 2) -> float:
    """Forward and backward operations of one ``height`` x ``width`` canvas
    (counted over ``batch`` of them, so that BatchNorm sees a batch)."""
    meta = torch.device("meta")
    sd = {k: torch.empty(shape, device=meta) for k, shape, _ in craft.param_spec()}
    params = {k: v.requires_grad_(True) for k, v in sd.items() if not craft_train.is_buffer(k)}
    b = {"images": torch.empty((batch, height, width, 3), device=meta),
         "region": torch.empty((batch, height // 2, width // 2), device=meta),
         "affinity": torch.empty((batch, height // 2, width // 2), device=meta)}
    with FlopCounterMode(display=False) as fc:
        loss, _, _ = craft_train.loss_of(craft_train.Net(params), b)
        torch.autograd.grad(loss, list(params.values()))
    return fc.get_total_flops() / batch
