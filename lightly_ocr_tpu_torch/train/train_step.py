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
from lightly_ocr_tpu_torch.models.layers import (
    frozen_batch_stats,
    init_train_params,
    sync_batch_norm,
)
from lightly_ocr_tpu_torch.ops.ctc import cross_entropy_ignore_index, ctc_loss
from lightly_ocr_tpu_torch.parallel.collectives import (
    all_reduce_grads_,
    global_sum,
    group_size,
    is_split,
    sync_replicated_grads_,
)
from lightly_ocr_tpu_torch.parallel.mesh import MeshGroups, mesh_groups
from lightly_ocr_tpu_torch.parallel.tensor import shard_module, sharded_mask
from lightly_ocr_tpu_torch.serving.batch import resolve_device
from lightly_ocr_tpu_torch.utils.profiling import annotate


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
def global_norm(grads: list[torch.Tensor], sharded=None, model_group=None) -> torch.Tensor:
    """The global L2 norm of ``grads``.  Where ``sharded[i]`` marks a slice
    of a tensor split over the model axis (:func:`~lightly_ocr_tpu_torch.
    parallel.tensor.sharded_mask`), its squares are summed over
    ``model_group`` and each replicated gradient counts once: the norm of
    one process's gradients.  No host sync."""
    norms = torch._foreach_norm(grads)
    if model_group is None or not any(sharded or ()):
        return torch.linalg.vector_norm(torch.stack(norms))

    def squares(keep: bool) -> torch.Tensor:
        part = [n for n, s in zip(norms, sharded) if s == keep]
        return torch.stack(part).square().sum() if part else norms[0].new_zeros(())

    return torch.sqrt(squares(False) + global_sum(squares(True), model_group))


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm: torch.Tensor | None = None) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: where the global norm
    (``norm``, else :func:`global_norm` of ``grads``) is ``>= max_norm``,
    each gradient becomes ``g / norm * max_norm``.  Returns the norm before
    the clip.  No host sync."""
    if norm is None:
        norm = global_norm(grads)
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, float(max_norm)))
    return norm


def flatten_lstms(model: torch.nn.Module) -> None:
    """cuDNN wants each ``nn.LSTM``'s weights in one block after a move."""
    for m in model.modules():
        if isinstance(m, torch.nn.LSTM):
            m.flatten_parameters()


def refuse_reduced_dtype_over_groups(dtype: torch.dtype, groups: MeshGroups) -> None:
    """Raise ``ValueError`` for a reduced compute dtype (fewer than 32 bits)
    with more than one process in ``groups``: the JAX package has no public
    path that shards a reduced-dtype state (its trainers build float32
    ones).  float32 and float64 pass with any groups."""
    if torch.finfo(dtype).bits < 32 and (groups.data_size > 1 or groups.model_size > 1):
        raise ValueError(
            f"compute dtype {dtype} with a {groups.data_size}x{groups.model_size} "
            "(data x model) group: training in a reduced dtype runs in one process "
            "only; train float32 over a group")


def init_train_state(cfg: Config, seed: int, device="cuda", group=None,
                     model: CRNNet | None = None) -> tuple[CRNNet, TrainState]:
    """A :class:`CRNNet` with the seeded training initialisation
    (:func:`init_train_params`), in training mode on ``device`` (the card
    unless the caller asks for the CPU; raises without one), and its
    optimizer at step 0.  ``model`` (e.g. ``CRNNet(cfg, dtype=torch.
    bfloat16)``) is the module to initialise, as the JAX package's
    ``init_train_state(cfg, rng, model)``: its weights are drawn from
    ``seed`` here, its parameters stay float32 and it computes in its
    ``dtype``.  With a model axis in ``group`` (a
    :class:`~lightly_ocr_tpu_torch.parallel.mesh.MeshGroups`) the model
    holds this rank's slices (:func:`~lightly_ocr_tpu_torch.parallel.
    tensor.shard_module`) and the optimizer steps on them; a reduced
    compute dtype with a group of more than one process raises
    (:func:`refuse_reduced_dtype_over_groups`)."""
    if cfg.quant_int8:
        # the int8 rounding has zero gradient: the quantized convs would
        # silently stop learning.  int8 is a serving mode only.
        raise ValueError(
            "Config.quant_int8=True is inference-only (QuantConv's "
            "rounding blocks gradients) — train in float and flip "
            "quant_int8 on at serving time"
        )
    groups = mesh_groups(group)
    model = CRNNet(cfg) if model is None else model
    refuse_reduced_dtype_over_groups(model.dtype, groups)
    device = resolve_device(device)
    init_train_params(model.float(), torch.Generator().manual_seed(int(seed)))
    model.to(device).train()
    shard_module(model, groups)
    flatten_lstms(model)
    return model, TrainState(model, make_optimizer(cfg, model.parameters()))


def _apply(model: CRNNet, images, text, remat: bool):
    if not remat:
        return model(images, text)
    return checkpoint(model, images, text, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), frozen_batch_stats(model)))


def loss_fn(model: CRNNet, cfg: Config, batch: dict, remat: bool = False, group=None):
    """-> (loss, logits).  ``batch``: ``images`` [B, H, W, C] in [-1, 1];
    CTC: ``labels`` [B, L] and ``lengths`` [B]; Attention: ``text`` [B,
    batch_max_len + 2] ([GO]-prefixed) and ``lengths``.  In ``train()`` the
    attention head is teacher-forced on ``text[:, :-1]`` against
    ``text[:, 1:]`` (``crnn.py:260-262``); in ``eval()`` its greedy decode
    is scored against the same targets.

    With ``group`` of more than one process, ``batch`` is this process's
    rows of the global batch and the loss is its share of the global one
    (the shares sum to it): the CTC mean divides by the global batch, the
    cross entropy by the global count of targets."""
    split = is_split(group)
    if cfg.prediction == "CTC":
        preds = _apply(model, batch["images"], None, remat)
        B, T = preds.shape[:2]
        logp = F.log_softmax(preds, dim=2)
        lengths_in = torch.full((B,), T, dtype=torch.long, device=preds.device)
        if split:
            per = ctc_loss(logp, batch["labels"], lengths_in, batch["lengths"], reduction="none")
            loss = (per / batch["lengths"].clamp_min(1).to(per.dtype)).sum() / (B * group_size(group))
        else:
            loss = ctc_loss(logp, batch["labels"], lengths_in, batch["lengths"])
    else:
        text = batch["text"]
        preds = _apply(model, batch["images"], text[:, :-1], remat)
        loss = cross_entropy_ignore_index(preds, text[:, 1:], ignore_index=0,
                                          count=(lambda n: global_sum(n, group)) if split else None)
    return loss, preds


def make_train_step(model: CRNNet, cfg: Config, group=None) -> Callable:
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``: one
    optimizer update of ``state`` in place (its step + 1); the metrics stay
    on the device.

    ``group`` (a ``torch.distributed`` process group, or a
    :class:`~lightly_ocr_tpu_torch.parallel.mesh.MeshGroups`) makes it one
    step of the parallel program.  Over the data group each process passes
    its rows of the global batch, BatchNorm normalises over the global batch
    (:func:`~lightly_ocr_tpu_torch.models.layers.sync_batch_norm`), the
    losses are the processes' shares of the global one
    (:func:`loss_fn`), and the gradients are summed over the processes
    before the clip, so every process applies the same update, that of the
    JAX package's step over the global batch; ``loss`` is the global loss.
    Over a model group (``model`` sharded by :func:`init_train_state`) the
    replicated tensors take model index 0's gradients (so the replicas
    stay equal bit for bit), the clip's norm counts each slice's squares
    over the group and each replicated gradient once, and the optimizer
    steps on the slices.  With
    one process in ``group`` the step is the single-device one, bit for
    bit."""
    accum = max(1, int(cfg.grad_accum))
    groups = mesh_groups(group)
    group = groups.data
    sync_batch_norm(model, group)
    params = list(model.parameters())
    sharded = sharded_mask(model)

    def train_step(state: TrainState, batch: dict):
        with annotate("train.step"):
            model.train()
            state.optimizer.zero_grad(set_to_none=True)
            if accum == 1:
                with annotate("train.forward"):
                    loss, _ = loss_fn(model, cfg, batch, cfg.train_remat, group)
                with annotate("train.backward"):
                    loss.backward()
            else:
                losses = []
                for i in range(accum):
                    with annotate("train.forward"):
                        micro, _ = loss_fn(model, cfg, {k: v[i] for k, v in batch.items()},
                                           cfg.train_remat, group)
                    with annotate("train.backward"):
                        micro.backward()  # .grad sums the micro-batches' gradients
                    losses.append(micro.detach())
                loss = torch.stack(losses).sum() / accum
            kept = [i for i, p in enumerate(params) if p.grad is not None]
            grads = [params[i].grad for i in kept]
            if group is not None:
                all_reduce_grads_(grads, group)
                loss = global_sum(loss.detach(), group)
            sync_replicated_grads_([params[i].grad for i in kept if not sharded[i]], groups)
            if accum > 1:
                torch._foreach_div_(grads, float(accum))
            with annotate("train.optimizer"):
                norm = clip_by_global_norm_(
                    grads, cfg.grad_clip, global_norm(grads, [sharded[i] for i in kept], groups.model))
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
