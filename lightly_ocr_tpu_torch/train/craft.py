"""CRAFT detector training (port of ``lightly_ocr_tpu/train/craft.py``).

    python -m lightly_ocr_tpu_torch.train.craft [--records det.lor] \
        [--num-steps 200] [--batch 4] [--height 256] [--width 192] \
        [--max-words 8] [--init-backbone vgg16_bn.pth] [--freeze slice1] \
        [--device cuda]

As the JAX package:

* **Supervision**: per-pixel gaussian heatmaps at the net's half
  resolution, the *region* target peaking at character centres, the
  *affinity* target between adjacent characters of a word.
  :func:`synthesize_batch` draws synthetic receipts with exact targets
  (numpy; one ``np.random.Generator`` gives the JAX package's arrays bit for
  bit); ``records=`` reads word boxes from a detection record file and
  splits them into characters (:mod:`.pseudo_labels`).
* **Loss**: MSE with online hard example mining (:func:`ohem_mse`) on each
  map: every positive pixel, and the hardest ``neg_ratio x num_pos``
  negatives of the whole batch, found by 16 halvings of the value axis (the
  JAX package's approximate k-th value, not the exact one of ``topk``),
  positives and negatives averaged apart.  No host sync.
* **Step**: forward in ``train()`` (BatchNorm on the batch's statistics)
  in the model's compute dtype on float32 parameters
  (``init_craft_state(dtype=...)``; :func:`train_craft` and the CLI train
  in float32, as the JAX package's), float32 maps, backward, optax's
  global-norm clip at 5, Adam.  Parameters
  under a ``basenet`` slice named in ``freeze`` get no update: their
  gradients are zeroed before the clip, so they are out of its norm (the
  reference's ``requires_grad=False``, ``ocr/modules/vgg_bn.py:57-60``);
  the reported ``grad_norm`` is the JAX package's, the norm of the raw
  gradients, frozen ones included.  Frozen BatchNorms still move their
  running statistics.
* **Loop**: :func:`train_craft` is :func:`init_craft_state`,
  :func:`make_craft_train_step`, :func:`craft_batches` (the batches from
  the seed) and :func:`fit_craft` (upload, step, the losses kept on the
  device and read back at the log points only).
* **Spans** (:func:`~lightly_ocr_tpu_torch.utils.profiling.annotate`,
  recorded only under a profiler), the training step's shared names where
  the CRNN's step has the same phase: ``train.step`` around a step,
  holding ``train.forward`` (the model call), ``craft.ohem`` (both
  OHEM-MSEs), ``train.backward`` and ``train.optimizer``
  (:func:`apply_craft_update`); in :func:`fit_craft`, ``craft.data``
  (drawing a batch), ``craft.upload`` (:func:`batch_to`) and ``train.sync``
  (each ``.item()`` at a log point).  Counter ``craft.upload_bytes``: the
  host bytes of each step's batch.
* **Checkpoints**: :mod:`lightly_ocr_tpu_torch.utils.checkpoint` (model,
  optimizer, step); ``load_variables_for_inference`` gives the state dict
  that ``engines.CRAFT(state_dict=...)`` and ``BatchedOCR`` load.

It runs on the card unless asked otherwise (``device="cpu"``); without one
the default raises.  ``--data-parallel`` trains data-parallel over every
visible device, one process each (:func:`lightly_ocr_tpu_torch.parallel.
launch.spawn`; NCCL), and under ``torchrun`` over its processes: the JAX
package's mesh step over the global batch (:func:`make_craft_train_step`
with ``group``).  As the JAX CLI's ``make_mesh()``, the CLI's mesh has a
model axis of 1; :func:`train_craft` takes a
:class:`~lightly_ocr_tpu_torch.parallel.mesh.MeshGroups` with a model axis
as the JAX ``train_craft(mesh=...)`` takes any mesh.
"""
from __future__ import annotations

import argparse
import itertools
from typing import Callable, Iterable, Iterator, Mapping, Sequence

import numpy as np
import torch

from lightly_ocr_tpu_torch.models.layers import init_train_params, sync_batch_norm
from lightly_ocr_tpu_torch.models.vgg_unet import _VGG_SLICES, VGG_UNet
from lightly_ocr_tpu_torch.parallel.collectives import (
    all_reduce_grads_,
    global_min_max,
    global_sum,
    group_size,
    sync_replicated_grads_,
)
from lightly_ocr_tpu_torch.parallel.launch import backend_for, from_torchrun, spawn
from lightly_ocr_tpu_torch.parallel.mesh import launched_by_torchrun, mesh_groups, visible_devices
from lightly_ocr_tpu_torch.parallel.tensor import shard_module, sharded_mask
from lightly_ocr_tpu_torch.serving.batch import resolve_device
from lightly_ocr_tpu_torch.train.train_step import (
    TrainState,
    clip_by_global_norm_,
    global_norm,
    refuse_reduced_dtype_over_groups,
)
from lightly_ocr_tpu_torch.utils.profiling import annotate, count

# ---------------------------------------------------------------------------
# Synthetic data with exact gaussian supervision (numpy, as the JAX package)
# ---------------------------------------------------------------------------


def _gaussian_patch(size: int = 64, spread: float = 2.5) -> np.ndarray:
    """Isotropic gaussian on [0,1]^2, peak 1 at the center."""
    ax = np.linspace(-spread, spread, size)
    g = np.exp(-0.5 * (ax[None, :] ** 2 + ax[:, None] ** 2))
    return (g / g.max()).astype(np.float32)


_GAUSS = _gaussian_patch()


def _paste_gaussian(target: np.ndarray, r0, c0, r1, c1) -> None:
    """max-compose the unit gaussian resized into the (half-res) box."""
    h, w = target.shape
    r0, c0 = max(int(r0), 0), max(int(c0), 0)
    r1, c1 = min(int(r1), h), min(int(c1), w)
    if r1 - r0 < 1 or c1 - c0 < 1:
        return
    gh, gw = r1 - r0, c1 - c0
    ys = (np.arange(gh) + 0.5) * (_GAUSS.shape[0] / gh)
    xs = (np.arange(gw) + 0.5) * (_GAUSS.shape[1] / gw)
    patch = _GAUSS[
        np.clip(ys.astype(np.int64), 0, _GAUSS.shape[0] - 1)[:, None],
        np.clip(xs.astype(np.int64), 0, _GAUSS.shape[1] - 1)[None, :],
    ]
    target[r0:r1, c0:c1] = np.maximum(target[r0:r1, c0:c1], patch)


def synthesize_batch(
    rng: np.random.Generator,
    batch: int,
    height: int = 256,
    width: int = 192,
    max_words: int = 8,
) -> dict[str, np.ndarray]:
    """Synthetic receipts + CRAFT targets: ``images [B,H,W,3]``
    (normalized-range floats), ``region`` and ``affinity`` ``[B,H/2,W/2]``
    gaussian targets."""
    H2, W2 = height // 2, width // 2
    images = np.zeros((batch, height, width, 3), np.float32)
    region = np.zeros((batch, H2, W2), np.float32)
    affinity = np.zeros((batch, H2, W2), np.float32)

    for b in range(batch):
        paper = 235 + rng.standard_normal((height, width)) * 4
        for _ in range(int(rng.integers(3, max_words + 1))):
            ch_h = int(rng.integers(14, 30))
            ch_w = int(rng.integers(9, max(10, ch_h)))
            n_ch = int(rng.integers(2, 8))
            gap = max(2, ch_w // 4)
            word_w = n_ch * ch_w + (n_ch - 1) * gap
            if word_w >= width - 12 or ch_h >= height - 12:
                continue
            r = int(rng.integers(6, height - ch_h - 6))
            c = int(rng.integers(6, width - word_w - 6))
            prev_center = None
            for i in range(n_ch):
                cc = c + i * (ch_w + gap)
                glyph = 30 + rng.random((ch_h, ch_w)) * 70
                # hollow the glyph a little so it looks like strokes
                if ch_h > 6 and ch_w > 6:
                    glyph[2:-2, 2:-2] = np.where(
                        rng.random((ch_h - 4, ch_w - 4)) < 0.4,
                        glyph[2:-2, 2:-2],
                        220,
                    )
                paper[r: r + ch_h, cc: cc + ch_w] = glyph
                _paste_gaussian(region[b], r / 2, cc / 2, (r + ch_h) / 2, (cc + ch_w) / 2)
                center = (r + ch_h / 2, cc + ch_w / 2)
                if prev_center is not None:
                    # the affinity spans the inner quarters of both
                    # characters, not just centre to centre, so the
                    # thresholded region and affinity zones overlap and
                    # word components do not split at wide character pairs
                    ar0 = (r - ch_h * 0.1) / 2
                    ar1 = (r + ch_h * 1.1) / 2
                    ac0 = (prev_center[1] - ch_w * 0.25) / 2
                    ac1 = (center[1] + ch_w * 0.25) / 2
                    _paste_gaussian(affinity[b], ar0, ac0, ar1, ac1)
                prev_center = center
        # ImageNet-style normalization range, equal channels
        img = np.clip(paper, 0, 255)[..., None].repeat(3, axis=2)
        images[b] = (img - 127.5) / 70.0

    return {"images": images, "region": region, "affinity": affinity}


def craft_batches(
    rng: np.random.Generator,
    batch: int,
    height: int,
    width: int,
    records: str | None = None,
    rows: slice | None = None,
    max_words: int = 8,
) -> Iterator[dict[str, np.ndarray]]:
    """Endless host batches of ``batch`` rows drawn with ``rng``:
    :func:`synthesize_batch` (``max_words`` words a canvas at most), or
    from the detection record file ``records``
    (:func:`~lightly_ocr_tpu_torch.train.pseudo_labels.batches_from_records`).
    ``rows`` keeps that slice of each batch (one process's share of a
    data-parallel run's global batch; every process draws the whole batch
    to keep ``rng`` in step, and from ``records`` decodes only its rows)."""
    if records is not None:
        from lightly_ocr_tpu_torch.train.pseudo_labels import batches_from_records

        yield from batches_from_records(records, batch, height, width, rng, rows=rows)
        return
    while True:
        data = synthesize_batch(rng, batch, height, width, max_words)
        yield data if rows is None else {k: v[rows] for k, v in data.items()}


# ---------------------------------------------------------------------------
# OHEM-MSE loss
# ---------------------------------------------------------------------------


def _kth_largest_threshold(values: torch.Tensor, k: torch.Tensor, group=None) -> torch.Tensor:
    """Approximate k-th largest of a 1D tensor by 16 value-axis halvings
    (the count of ``values >= mid`` is monotone in ``mid``): the JAX
    package's threshold, which is not the exact k-th value.  No host sync.
    With ``group``, ``values`` is this process's part of the global array:
    the ``min``, the ``max`` and every halving's count are the global ones."""
    lo, hi = global_min_max(values, group)
    for _ in range(16):
        mid = 0.5 * (lo + hi)
        above = global_sum((values >= mid).sum(), group) > k
        lo, hi = torch.where(above, mid, lo), torch.where(above, hi, mid)
    return lo


def ohem_masks(
    pred: torch.Tensor,  # [B, H2, W2]
    target: torch.Tensor,
    pos_thresh: float = 0.1,
    neg_ratio: float = 3.0,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(squared error, positives, hard negatives) of OHEM: every pixel whose
    target is above ``pos_thresh``, and the negatives whose error reaches
    the approximate ``k``-th largest negative error of the whole flattened
    batch, ``k = min(int32(neg_ratio * num_pos), N - 1)``.  With ``group``
    the batch is every process's rows: ``num_pos``, ``N`` and the threshold
    are global."""
    err = (pred - target) ** 2
    pos = target > pos_thresh
    num_pos = global_sum(pos.sum(), group).clamp_min(1)
    neg_err = torch.where(pos, 0.0, err).reshape(-1)
    # the JAX package's float32 product, truncated to int32
    n = neg_err.shape[0] * group_size(group)
    k = (neg_ratio * num_pos.float()).int().clamp_max(n - 1)
    thresh = _kth_largest_threshold(neg_err, k, group)
    return err, pos, ~pos & (err >= thresh)


def ohem_mse(
    pred: torch.Tensor,  # [B, H2, W2]
    target: torch.Tensor,
    pos_thresh: float = 0.1,
    neg_ratio: float = 3.0,
    group=None,
) -> torch.Tensor:
    """Mean squared error over all positives + the hardest negatives
    (:func:`ohem_masks`), the two averaged apart (an all-easy negative
    field then adds ~0 instead of diluting the positive term).  With
    ``group`` it is this process's share of the global loss: its sums over
    the global counts."""
    err, pos, hard_neg = ohem_masks(pred, target, pos_thresh, neg_ratio, group)
    counts = global_sum(torch.stack([pos.sum(), hard_neg.sum()]), group).clamp_min(1)
    pos_loss = torch.where(pos, err, 0.0).sum() / counts[0]
    neg_loss = torch.where(hard_neg, err, 0.0).sum() / counts[1]
    return pos_loss + neg_loss


def craft_loss(model: VGG_UNet, batch: Mapping[str, torch.Tensor], group=None) -> torch.Tensor:
    """OHEM-MSE of the region map plus that of the affinity map, on the
    float32 score maps of ``model`` (in whatever mode it is in); with
    ``group``, this process's share of the global batch's loss."""
    with annotate("train.forward"):
        maps, _ = model(batch["images"])
        maps = maps.to(torch.promote_types(maps.dtype, torch.float32))
    with annotate("craft.ohem"):
        return (ohem_mse(maps[..., 0], batch["region"], group=group)
                + ohem_mse(maps[..., 1], batch["affinity"], group=group))


# ---------------------------------------------------------------------------
# Optimizer, backbone init, state, step
# ---------------------------------------------------------------------------


def make_craft_optimizer(params, lr: float = 1e-3) -> torch.optim.Optimizer:
    """optax's ``adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8).  The clip and the
    freeze are applied to the gradients first (:func:`apply_craft_update`)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def frozen_mask(model: torch.nn.Module, freeze: Sequence[str] = ()) -> list[bool]:
    """For each of ``model.parameters()``: whether it lies under a module
    named in ``freeze`` (e.g. ``("slice1",)`` pins ``basenet.slice1.*``).
    Raises ``ValueError`` for a name that matches no module (a typo would
    otherwise freeze nothing)."""
    names = frozenset(freeze)
    paths = [set(n.split(".")[:-1]) for n, _ in model.named_parameters()]
    unknown = names - set().union(*paths)
    if unknown:
        raise ValueError(f"freeze: no module named {sorted(unknown)}")
    return [bool(names & path) for path in paths]


@torch.no_grad()
def apply_craft_update(optimizer: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                       frozen: Sequence[bool], clip: float = 5.0, group=None,
                       sharded: Sequence[bool] | None = None) -> torch.Tensor:
    """The JAX package's optimizer chain on the gradients in ``.grad``:
    (with ``group``, a data group) the gradients summed over the processes,
    frozen gradients zeroed (out of the clip's norm), optax's global-norm
    clip, then the step.  Returns the global norm of the raw gradients,
    frozen ones included (the JAX step's ``grad_norm``).  ``sharded`` marks
    the slices of a model axis, ``group`` then a
    :class:`~lightly_ocr_tpu_torch.parallel.mesh.MeshGroups` whose model
    group the norms sum them over (:func:`~lightly_ocr_tpu_torch.train.
    train_step.global_norm`); the replicated tensors take model index 0's
    gradients.  No host sync."""
    groups = mesh_groups(group)
    grads = [p.grad for p in params]
    all_reduce_grads_(grads, groups.data)
    if sharded is not None:
        sync_replicated_grads_([g for g, s in zip(grads, sharded) if not s], groups)

    def norm_of(gs):
        return global_norm(gs, sharded, groups.model)

    norm = norm_of(grads)
    if any(frozen):
        torch._foreach_zero_([g for g, f in zip(grads, frozen) if f])
        clip_by_global_norm_(grads, clip, norm_of(grads))
    else:
        clip_by_global_norm_(grads, clip, norm)
    optimizer.step()
    return norm


@torch.no_grad()
def load_torchvision_backbone(model: VGG_UNet, source) -> VGG_UNet:
    """Seed ``basenet`` slices 1-4 of ``model`` from a torchvision
    ``vgg16_bn`` classifier state dict (the reference's pretrained init,
    ``ocr/modules/vgg_bn.py:36-43``; slice5's fc6/fc7 keep their init,
    ``vgg_bn.py:52-55``).

    ``source`` is a ``.pth`` path (``torch.load``, ``weights_only``) or a
    mapping of arrays or tensors with torchvision's ``features.{idx}.*``
    keys, or with the bare ``{idx}.*`` keys of the ``features`` module.  The
    port's slice modules are named by torchvision's indices, so the copy is
    direct.  Raises ``KeyError`` on a missing key and ``ValueError`` on a
    shape mismatch (a silent partial init would be a debugging trap)."""
    if isinstance(source, str):
        from lightly_ocr_tpu_torch.weights import strip_module_prefix

        source = strip_module_prefix(torch.load(source, map_location="cpu", weights_only=True))
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in source.items()}
    if not any(k.startswith("features.") for k in sd):
        sd = {f"features.{k}": v for k, v in sd.items()}

    def put(dst: torch.Tensor, key: str, name: str) -> None:
        value = sd[key]
        if tuple(dst.shape) != tuple(value.shape):
            raise ValueError(f"{name}: shape {tuple(dst.shape)} vs torchvision {tuple(value.shape)}")
        dst.copy_(value.to(dst.dtype))

    for slice_name, ops in _VGG_SLICES.items():
        mods = getattr(model.basenet, slice_name)
        for op in ops:
            if op[0] != "C":
                continue
            idx = op[1]
            conv, bn = mods[str(idx)], mods[str(idx + 1)]
            for t, key in ((conv.weight, f"{idx}.weight"), (conv.bias, f"{idx}.bias"),
                           (bn.weight, f"{idx + 1}.weight"), (bn.bias, f"{idx + 1}.bias"),
                           (bn.running_mean, f"{idx + 1}.running_mean"),
                           (bn.running_var, f"{idx + 1}.running_var")):
                put(t, f"features.{key}", f"basenet.{slice_name}.{key}")
    return model


def init_craft_state(
    seed: int = 0,
    lr: float = 1e-3,
    device="cuda",
    init_backbone=None,
    freeze: Sequence[str] = (),
    group=None,
    dtype: torch.dtype = torch.float32,
) -> tuple[VGG_UNet, TrainState]:
    """A :class:`VGG_UNet` with float32 parameters computing in ``dtype``
    (the JAX package's ``init_craft_state(dtype=...)``), flax's seeded
    training initialisation (:func:`init_train_params`), slices 1-4 from
    ``init_backbone`` where given (:func:`load_torchvision_backbone`), in
    ``train()`` on ``device`` (the card unless the caller asks for the CPU;
    raises without one), and its float32 Adam at step 0.  The optimizer
    holds every parameter: ``freeze`` (checked here against the model's
    module names) is applied by the step that :func:`make_craft_train_step`
    makes.  With a model axis in ``group`` (a :class:`~lightly_ocr_tpu_torch.
    parallel.mesh.MeshGroups`) the model holds this rank's slices; a
    reduced ``dtype`` with a group of more than one process raises
    (:func:`~lightly_ocr_tpu_torch.train.train_step.
    refuse_reduced_dtype_over_groups`)."""
    groups = mesh_groups(group)
    refuse_reduced_dtype_over_groups(dtype, groups)
    device = resolve_device(device)
    model = init_train_params(VGG_UNet(dtype=dtype), torch.Generator().manual_seed(int(seed)))
    frozen_mask(model, freeze)
    if init_backbone is not None:
        load_torchvision_backbone(model, init_backbone)
    model.to(device).train()
    shard_module(model, groups)
    return model, TrainState(model, make_craft_optimizer(model.parameters(), lr))


def batch_to(batch: Mapping[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """A host batch (``images``, ``region``, ``affinity``) as float32
    tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device, non_blocking=True)
            for k, v in batch.items()}


def make_craft_train_step(
    model: VGG_UNet, clip: float = 5.0, freeze: Sequence[str] = (), group=None
) -> Callable:
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``: one
    update of ``state`` in place (its step + 1) on a batch of tensors on the
    model's device; the metrics stay on the device.  ``group`` makes it one
    step of the parallel program (as :func:`~lightly_ocr_tpu_torch.train.
    train_step.make_train_step`): over the data group's rows of the global
    batch, BatchNorm, OHEM and both normalisers over the global batch, the
    gradients summed before the freeze and the clip, ``loss`` the global
    loss; over a model group (``model`` sharded), the norms over the slices
    of every rank."""
    params = list(model.parameters())
    frozen = frozen_mask(model, freeze)
    sharded = sharded_mask(model)
    groups = mesh_groups(group)
    data = groups.data
    sync_batch_norm(model, data)

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        with annotate("train.step"):
            model.train()
            state.optimizer.zero_grad(set_to_none=True)
            loss = craft_loss(model, batch, data)
            with annotate("train.backward"):
                loss.backward()
            with annotate("train.optimizer"):
                norm = apply_craft_update(state.optimizer, params, frozen, clip, groups, sharded)
            if data is not None:
                loss = global_sum(loss.detach(), data)
            state.step += 1
            return state, {"loss": loss.detach(), "grad_norm": norm}

    return train_step


def fit_craft(
    state: TrainState,
    step_fn: Callable,
    batches: Iterable[Mapping[str, np.ndarray]],
    device,
    *,
    log_every: int = 20,
    log_fn: Callable[[str], None] = print,
    num_steps: int | None = None,
) -> list[torch.Tensor]:
    """Train on ``batches`` (host batches shaped as :func:`synthesize_batch`'s;
    at most ``num_steps`` of them where given): each uploaded with
    :func:`batch_to`, stepped with ``step_fn`` (:func:`make_craft_train_step`).
    Returns each step's loss, kept on the device; the loss and the gradient
    norm are read back only every ``log_every`` steps (0: never), for the
    line given to ``log_fn``."""
    losses: list[torch.Tensor] = []
    it = iter(batches)
    of = "" if num_steps is None else f"/{num_steps}"
    for i in itertools.count(1) if num_steps is None else range(1, num_steps + 1):
        with annotate("craft.data"):
            data = next(it, None)
        if data is None:
            break
        with annotate("craft.upload"):
            batch = batch_to(data, device)
        count("craft.upload_bytes", sum(t.numel() * t.element_size() for t in batch.values()))
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"])
        if log_every and i % log_every == 0:
            with annotate("train.sync"):
                loss = losses[-1].item()
            with annotate("train.sync"):
                norm = metrics["grad_norm"].item()
            log_fn(f"craft step {i}{of} loss {loss:.5f} gnorm {norm:.3f}")
    return losses


def train_craft(
    num_steps: int = 200,
    batch: int = 4,
    height: int = 256,
    width: int = 192,
    lr: float = 1e-3,
    seed: int = 0,
    device="cuda",
    log_every: int = 20,
    checkpoint_dir: str | None = None,
    log_fn: Callable[[str], None] = print,
    records: str | None = None,
    init_backbone=None,
    freeze: Sequence[str] = (),
    group=None,
    max_words: int = 8,
) -> tuple[VGG_UNet, TrainState, list[float]]:
    """Detector training on synthetic data, or on a detection record file
    (``records``: word rects + transcripts, split into character gaussians
    by :mod:`.pseudo_labels`).  The batches come from
    ``np.random.default_rng(seed)`` as in the JAX package
    (:func:`craft_batches`; ``max_words`` words a synthetic canvas at
    most), through :func:`fit_craft`.  The losses are read from the device
    only at the log points and at the end.

    ``group`` (a ``torch.distributed`` process group, one process per
    device; :func:`main`'s ``--data-parallel``) trains data-parallel: every
    process draws the same global batch of ``batch`` rows from the seed and
    steps on its contiguous share of them (``batch`` must divide by the
    processes; from ``records`` it decodes only those rows, while every
    process synthesizes the whole batch to keep the generator in step);
    rank 0 alone logs and writes the checkpoint.  A
    :class:`~lightly_ocr_tpu_torch.parallel.mesh.MeshGroups` with a model
    axis splits the batch by data index and the weights over the model
    group (its ranks gather the checkpoint together)."""
    groups = mesh_groups(group)
    rng = np.random.default_rng(seed)
    model, state = init_craft_state(seed, lr, device, init_backbone, freeze, groups)
    dev = next(model.parameters()).device
    step_fn = make_craft_train_step(model, freeze=freeze, group=groups)
    rank, n = groups.data_index, groups.data_size
    per = batch // n
    if per * n != batch:
        raise ValueError(f"batch {batch} does not split over {n} processes")
    batches = craft_batches(rng, batch, height, width, records, slice(rank * per, (rank + 1) * per),
                            max_words)
    losses = fit_craft(state, step_fn, batches, dev, log_every=log_every if groups.lead else 0,
                       log_fn=log_fn, num_steps=num_steps)
    if checkpoint_dir and rank == 0:  # the model group of data index 0
        from lightly_ocr_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(checkpoint_dir, state.step, state)
    return model, state, torch.stack(losses).cpu().tolist() if losses else []


def main(argv: Sequence[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="CRAFT detector training")
    p.add_argument("--num-steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=192)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--records", default=None,
                   help="LOR1 detection record file (word boxes + transcripts "
                        "-> character pseudo-labels); default: synthetic data")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the batch over all visible devices: one process each "
                        "(under torchrun, its processes)")
    p.add_argument("--init-backbone", default=None,
                   help="torchvision vgg16_bn state-dict .pth to seed basenet "
                        "slices 1-4 (reference vgg_bn.py:36-43)")
    p.add_argument("--freeze", default="",
                   help="comma list of basenet slices to freeze, e.g. 'slice1' "
                        "(reference vgg_bn.py:57-60)")
    p.add_argument("--max-words", type=int, default=8,
                   help="most words a synthetic canvas holds (at least 3)")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the CPU only when asked)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    kw = dict(num_steps=args.num_steps, batch=args.batch, height=args.height, width=args.width,
              lr=args.lr, seed=args.seed, log_every=args.log_every,
              checkpoint_dir=args.checkpoint_dir, records=args.records, max_words=args.max_words,
              init_backbone=args.init_backbone,
              freeze=tuple(t for t in args.freeze.split(",") if t))
    if launched_by_torchrun():
        dev, group = from_torchrun(dev)
        losses = _craft_rank(kw, device=dev, group=group)
    elif args.data_parallel and len(devices := visible_devices(dev)) > 1:
        print(f"craft training data-parallel on {len(devices)} devices "
              f"({backend_for(devices)})", flush=True)
        losses = spawn(_craft_rank, (kw,), devices)
    else:
        losses = _craft_rank(kw, device=dev)
    if losses:
        print(f"final loss {losses[-1]:.5f} (first {losses[0]:.5f})", flush=True)
    return 0


def _craft_rank(kw: dict, device, group=None) -> list[float] | None:
    """One process of :func:`main`'s run: :func:`train_craft` on ``device``;
    rank 0 returns the losses."""
    lead = mesh_groups(group).lead
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host"
    if lead:
        print(f"craft training on device {device} ({name})", flush=True)
    _, _, losses = train_craft(**kw, device=device, group=group)
    return losses if lead else None


if __name__ == "__main__":
    raise SystemExit(main())
