"""CRNN training and eval steps (port of
``lightly_ocr_tpu/train/train_step.py``).

Reference train loop internals (``ocr/train/crnn.py:240-268``): the
forward (teacher-forced for the attention head; log-softmax + CTC for the
CTC head), the gradient clipped to a global norm of 5, then Adadelta (rho
0.95, eps 1e-8) or Adam.  As the JAX package:

* the clip is optax's ``clip_by_global_norm``: ``g / norm * max`` only
  when ``norm >= max`` (``torch.nn.utils.clip_grad_norm_`` divides by
  ``norm + 1e-6`` always, a different number);
* ``grad_accum`` > 1: every leaf of the batch carries a leading
  ``[grad_accum]`` dim; the micro-batches run one after another (one
  micro-batch's activations live at a time), BatchNorm statistics move
  once per micro-batch, the gradients and losses are averaged and one
  update is applied;
* ``train_remat``: the forward is recomputed in the backward
  (``torch.utils.checkpoint``, non-reentrant); the recomputation does not
  move the BatchNorm running statistics a second time, as JAX's
  functional BatchNorm has no such side effect;
* the optimizer state is part of the state and of its checkpoints.

The JAX package leaves all of this to XLA (no Pallas kernel), so stock
PyTorch ops and autograd serve here.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.layers import frozen_batch_stats, init_train_params
from lightly_ocr_tpu_torch.ops.ctc import cross_entropy_ignore_index, ctc_loss
from lightly_ocr_tpu_torch.serving.batch import resolve_device


@dataclass
class TrainState:
    model: torch.nn.Module  # CRNNet, or VGG_UNet (train/craft.py)
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """Adam or Adadelta per config (``crnn.py:126-129``); optax's
    ``adam(lr, b1=beta1, b2=0.999)`` (eps 1e-8) or ``adadelta(lr, rho,
    eps)``.  The clip is separate (:func:`clip_by_global_norm_`)."""
    if cfg.adam:
        return torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.beta1, 0.999), eps=1e-8)
    return torch.optim.Adadelta(params, lr=cfg.lr, rho=cfg.rho, eps=cfg.eps)


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: where the global norm is
    ``>= max_norm``, each gradient becomes ``g / norm * max_norm``.  Returns
    the norm before the clip.  No host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, float(max_norm)))
    return norm


def flatten_lstms(model: torch.nn.Module) -> None:
    """cuDNN wants each ``nn.LSTM``'s weights in one block after a move."""
    for m in model.modules():
        if isinstance(m, torch.nn.LSTM):
            m.flatten_parameters()


def init_train_state(cfg: Config, seed: int, device="cuda") -> tuple[CRNNet, TrainState]:
    """A :class:`CRNNet` with the seeded training initialisation
    (:func:`init_train_params`), in training mode on ``device`` (the card
    unless the caller asks for the CPU; raises without one), and its
    optimizer at step 0."""
    if cfg.quant_int8:
        # the int8 rounding has zero gradient: the quantized convs would
        # silently stop learning.  int8 is a serving mode only.
        raise ValueError(
            "Config.quant_int8=True is inference-only (QuantConv's "
            "rounding blocks gradients) — train in float and flip "
            "quant_int8 on at serving time"
        )
    device = resolve_device(device)
    model = init_train_params(CRNNet(cfg), torch.Generator().manual_seed(int(seed)))
    model.to(device).train()
    flatten_lstms(model)
    return model, TrainState(model, make_optimizer(cfg, model.parameters()))


def _apply(model: CRNNet, images, text, remat: bool):
    if not remat:
        return model(images, text)
    return checkpoint(model, images, text, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), frozen_batch_stats(model)))


def loss_fn(model: CRNNet, cfg: Config, batch: dict, remat: bool = False):
    """-> (loss, logits).  ``batch``: ``images`` [B, H, W, C] in [-1, 1];
    CTC: ``labels`` [B, L] and ``lengths`` [B]; Attention: ``text`` [B,
    batch_max_len + 2] ([GO]-prefixed) and ``lengths``.  In ``train()`` the
    attention head is teacher-forced on ``text[:, :-1]`` against
    ``text[:, 1:]`` (``crnn.py:260-262``); in ``eval()`` its greedy decode
    is scored against the same targets."""
    if cfg.prediction == "CTC":
        preds = _apply(model, batch["images"], None, remat)
        B, T = preds.shape[:2]
        logp = F.log_softmax(preds, dim=2)
        lengths_in = torch.full((B,), T, dtype=torch.long, device=preds.device)
        loss = ctc_loss(logp, batch["labels"], lengths_in, batch["lengths"])
    else:
        text = batch["text"]
        preds = _apply(model, batch["images"], text[:, :-1], remat)
        loss = cross_entropy_ignore_index(preds, text[:, 1:], ignore_index=0)
    return loss, preds


def make_train_step(model: CRNNet, cfg: Config) -> Callable:
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``: one
    optimizer update of ``state`` in place (its step + 1); the metrics stay
    on the device."""
    accum = max(1, int(cfg.grad_accum))

    def train_step(state: TrainState, batch: dict):
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        if accum == 1:
            loss, _ = loss_fn(model, cfg, batch, cfg.train_remat)
            loss.backward()
        else:
            losses = []
            for i in range(accum):
                micro, _ = loss_fn(model, cfg, {k: v[i] for k, v in batch.items()},
                                   cfg.train_remat)
                micro.backward()  # .grad sums the micro-batches' gradients
                losses.append(micro.detach())
            loss = torch.stack(losses).sum() / accum
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
        norm = clip_by_global_norm_(grads, cfg.grad_clip)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": norm}

    return train_step


def make_eval_step(model: CRNNet, cfg: Config) -> Callable:
    """``eval_step(state, batch) -> {"loss", "pred_idx", "confidence"}`` in
    ``eval()`` mode (the model's mode is put back after).  Confidence as the
    JAX package: CTC the product of every frame's max probability;
    Attention the product over the steps before the first ``[s]``."""
    is_ctc = cfg.prediction == "CTC"

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        was_training = model.training
        model.eval()
        try:
            loss, preds = loss_fn(model, cfg, batch)
        finally:
            model.train(was_training)
        max_probs = torch.softmax(preds.float(), dim=2).amax(2)
        idx = preds.argmax(2)
        if is_ctc:
            conf = max_probs.prod(1)
        else:
            before = torch.cumsum(idx == 1, 1) == 0
            conf = torch.where(before, max_probs, 1.0).prod(1)
        return {"loss": loss, "pred_idx": idx, "confidence": conf}

    return eval_step
