"""CRAFT detector training (port of ``lightly_ocr_tpu/train/craft.py``).

    python -m lightly_ocr_tpu_torch.train.craft [--records det.lor] \
        [--num-steps 200] [--batch 4] [--height 256] [--width 192] \
        [--init-backbone vgg16_bn.pth] [--freeze slice1] [--device cuda]

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
* **Step**: forward in ``train()`` (BatchNorm on the batch's statistics),
  float32 maps, backward, optax's global-norm clip at 5, Adam.  Parameters
  under a ``basenet`` slice named in ``freeze`` get no update: their
  gradients are zeroed before the clip, so they are out of its norm (the
  reference's ``requires_grad=False``, ``ocr/modules/vgg_bn.py:57-60``);
  the reported ``grad_norm`` is the JAX package's, the norm of the raw
  gradients, frozen ones included.  Frozen BatchNorms still move their
  running statistics.
* **Checkpoints**: :mod:`lightly_ocr_tpu_torch.utils.checkpoint` (model,
  optimizer, step); ``load_variables_for_inference`` gives the state dict
  that ``engines.CRAFT(state_dict=...)`` and ``BatchedOCR`` load.

It runs on the card unless asked otherwise (``device="cpu"``); without one
the default raises.  The JAX package shards the batch over a device mesh
(``--data-parallel``); that is not ported (ROADMAP Queue 1, parallelism).
"""
from __future__ import annotations

import argparse
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from lightly_ocr_tpu_torch.models.layers import init_train_params
from lightly_ocr_tpu_torch.models.vgg_unet import _VGG_SLICES, VGG_UNet
from lightly_ocr_tpu_torch.serving.batch import resolve_device
from lightly_ocr_tpu_torch.train.train_step import TrainState, clip_by_global_norm_

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


# ---------------------------------------------------------------------------
# OHEM-MSE loss
# ---------------------------------------------------------------------------


def _kth_largest_threshold(values: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Approximate k-th largest of a 1D tensor by 16 value-axis halvings
    (the count of ``values >= mid`` is monotone in ``mid``): the JAX
    package's threshold, which is not the exact k-th value.  No host sync."""
    lo, hi = values.min(), values.max()
    for _ in range(16):
        mid = 0.5 * (lo + hi)
        above = (values >= mid).sum() > k
        lo, hi = torch.where(above, mid, lo), torch.where(above, hi, mid)
    return lo


def ohem_masks(
    pred: torch.Tensor,  # [B, H2, W2]
    target: torch.Tensor,
    pos_thresh: float = 0.1,
    neg_ratio: float = 3.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(squared error, positives, hard negatives) of OHEM: every pixel whose
    target is above ``pos_thresh``, and the negatives whose error reaches
    the approximate ``k``-th largest negative error of the whole flattened
    batch, ``k = min(int32(neg_ratio * num_pos), N - 1)``."""
    err = (pred - target) ** 2
    pos = target > pos_thresh
    num_pos = pos.sum().clamp_min(1)
    neg_err = torch.where(pos, 0.0, err).reshape(-1)
    # the JAX package's float32 product, truncated to int32
    k = (neg_ratio * num_pos.float()).int().clamp_max(neg_err.shape[0] - 1)
    thresh = _kth_largest_threshold(neg_err, k)
    return err, pos, ~pos & (err >= thresh)


def ohem_mse(
    pred: torch.Tensor,  # [B, H2, W2]
    target: torch.Tensor,
    pos_thresh: float = 0.1,
    neg_ratio: float = 3.0,
) -> torch.Tensor:
    """Mean squared error over all positives + the hardest negatives
    (:func:`ohem_masks`), the two averaged apart (an all-easy negative
    field then adds ~0 instead of diluting the positive term)."""
    err, pos, hard_neg = ohem_masks(pred, target, pos_thresh, neg_ratio)
    pos_loss = torch.where(pos, err, 0.0).sum() / pos.sum().clamp_min(1)
    neg_loss = torch.where(hard_neg, err, 0.0).sum() / hard_neg.sum().clamp_min(1)
    return pos_loss + neg_loss


def craft_loss(model: VGG_UNet, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """OHEM-MSE of the region map plus that of the affinity map, on the
    float32 score maps of ``model`` (in whatever mode it is in)."""
    maps, _ = model(batch["images"])
    maps = maps.to(torch.promote_types(maps.dtype, torch.float32))
    return ohem_mse(maps[..., 0], batch["region"]) + ohem_mse(maps[..., 1], batch["affinity"])


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
                       frozen: Sequence[bool], clip: float = 5.0) -> torch.Tensor:
    """The JAX package's optimizer chain on the gradients in ``.grad``:
    frozen gradients zeroed (out of the clip's norm), optax's global-norm
    clip, then the step.  Returns the global norm of the raw gradients,
    frozen ones included (the JAX step's ``grad_norm``).  No host sync."""
    grads = [p.grad for p in params]
    if any(frozen):
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_zero_([g for g, f in zip(grads, frozen) if f])
        clip_by_global_norm_(grads, clip)
    else:
        norm = clip_by_global_norm_(grads, clip)
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
) -> tuple[VGG_UNet, TrainState]:
    """A float32 :class:`VGG_UNet` with flax's seeded training
    initialisation (:func:`init_train_params`), slices 1-4 from
    ``init_backbone`` where given (:func:`load_torchvision_backbone`), in
    ``train()`` on ``device`` (the card unless the caller asks for the CPU;
    raises without one), and its Adam at step 0.  The optimizer holds every
    parameter: ``freeze`` (checked here against the model's module names)
    is applied by the step that :func:`make_craft_train_step` makes."""
    device = resolve_device(device)
    model = init_train_params(VGG_UNet(), torch.Generator().manual_seed(int(seed)))
    frozen_mask(model, freeze)
    if init_backbone is not None:
        load_torchvision_backbone(model, init_backbone)
    model.to(device).train()
    return model, TrainState(model, make_craft_optimizer(model.parameters(), lr))


def batch_to(batch: Mapping[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """A host batch (``images``, ``region``, ``affinity``) as float32
    tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device, non_blocking=True)
            for k, v in batch.items()}


def make_craft_train_step(
    model: VGG_UNet, clip: float = 5.0, freeze: Sequence[str] = ()
) -> Callable:
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``: one
    update of ``state`` in place (its step + 1) on a batch of tensors on the
    model's device; the metrics stay on the device."""
    params = list(model.parameters())
    frozen = frozen_mask(model, freeze)

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = craft_loss(model, batch)
        loss.backward()
        norm = apply_craft_update(state.optimizer, params, frozen, clip)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": norm}

    return train_step


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
) -> tuple[VGG_UNet, TrainState, list[float]]:
    """Detector training on synthetic data, or on a detection record file
    (``records``: word rects + transcripts, split into character gaussians
    by :mod:`.pseudo_labels`).  The batches come from
    ``np.random.default_rng(seed)`` as in the JAX package.  The losses are
    read from the device only at the log points and at the end."""
    rng = np.random.default_rng(seed)
    model, state = init_craft_state(seed, lr, device, init_backbone, freeze)
    dev = next(model.parameters()).device
    step_fn = make_craft_train_step(model, freeze=freeze)
    data_iter = None
    if records is not None:
        from lightly_ocr_tpu_torch.train.pseudo_labels import batches_from_records

        data_iter = batches_from_records(records, batch, height, width, rng)
    losses: list[torch.Tensor] = []
    for i in range(num_steps):
        data = next(data_iter) if data_iter is not None else synthesize_batch(rng, batch, height, width)
        state, metrics = step_fn(state, batch_to(data, dev))
        losses.append(metrics["loss"])
        if log_every and (i + 1) % log_every == 0:
            log_fn(f"craft step {i + 1}/{num_steps} loss {losses[-1].item():.5f} "
                   f"gnorm {metrics['grad_norm'].item():.3f}")
    if checkpoint_dir:
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
                   help="shard the batch over all devices (not ported: raises)")
    p.add_argument("--init-backbone", default=None,
                   help="torchvision vgg16_bn state-dict .pth to seed basenet "
                        "slices 1-4 (reference vgg_bn.py:36-43)")
    p.add_argument("--freeze", default="",
                   help="comma list of basenet slices to freeze, e.g. 'slice1' "
                        "(reference vgg_bn.py:57-60)")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the CPU only when asked)")
    args = p.parse_args(argv)
    if args.data_parallel:
        raise NotImplementedError(
            "--data-parallel is not ported: the port trains on one device "
            "(ROADMAP.md Queue 1, item 2: parallelism)")
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    print(f"craft training on device {dev} ({name})", flush=True)
    _, _, losses = train_craft(
        num_steps=args.num_steps,
        batch=args.batch,
        height=args.height,
        width=args.width,
        lr=args.lr,
        seed=args.seed,
        device=dev,
        log_every=args.log_every,
        checkpoint_dir=args.checkpoint_dir,
        records=args.records,
        init_backbone=args.init_backbone,
        freeze=tuple(t for t in args.freeze.split(",") if t),
    )
    print(f"final loss {losses[-1]:.5f} (first {losses[0]:.5f})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
