"""CRAFT detector training, plain PyTorch: one step of the recipe of Baek et
al. (CVPR 2019, arXiv:1904.01941) on the detector of ``craft.py``, in the
dtype of the tensors it is given (float32 on the card, with TF32 off).

A step:

* the forward in training mode: every BatchNorm normalises with the batch's
  statistics over (N, H, W) and the biased variance, and its running
  statistics move by ``running = 0.9 * running + 0.1 * batch`` with that
  biased variance (flax's rule, which the program follows);
* the loss of each score map (channel 0 region, channel 1 affinity against
  its gaussian target): MSE with online hard negative mining, every positive
  pixel (target above 0.1) and the hardest negatives of the whole batch at 3
  negatives a positive, the two averaged apart, region plus affinity;
* gradients by autograd, clipped to a global norm of 5 where the norm reaches
  it (``g / norm * 5``);
* Adam: lr 1e-3, betas 0.9 / 0.999, eps 1e-8, bias-corrected.

Departures from the paper, each the program's stated semantics:

* the hard negatives are not the exact top ``k`` of ``topk``: ``k =
  min(int32(3 * num_pos), N - 1)``, and the negatives kept are those whose
  error reaches a threshold found by 16 halvings of the value axis between
  the negatives' least and largest error (positives count as error 0
  there), keeping the half whose count of values at or above the midpoint
  exceeds ``k``; the approximate k-th value of the program and of the JAX
  package it was ported from;
* the paper's targets come from its weak supervision of real images; here
  they are the exact gaussians the program synthesizes;
* no learning-rate schedule and no freeze of the backbone (the cell's
  configuration has none).

``control`` is the same step with TF32 products in cuDNN and matmuls, the
precision below float32's.  The variants the check plants in the program's
place: ``half_batch`` (the loss of the first half of the batch alone) and
``positives_only`` (the positive terms alone, no hard negatives).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ocr_bench.reference.common import conv, float32_exact
from ocr_bench.reference.craft import HEAD, VGG

MOMENTUM = 0.1
BN_EPS = 1e-5
POS_THRESH = 0.1
NEG_RATIO = 3.0
HALVINGS = 16
CLIP = 5.0
LR, BETA1, BETA2, ADAM_EPS = 1e-3, 0.9, 0.999, 1e-8
VARIANTS = (None, "half_batch", "positives_only")


@contextlib.contextmanager
def precision(control: bool = False):
    """TF32 off for cuDNN and matmuls inside the block, or on with
    ``control``; the caller's settings back after."""
    with float32_exact():
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(control)
        yield


def is_buffer(key: str) -> bool:
    return key.endswith(("running_mean", "running_var"))


class Net:
    """The detector's forward in training mode over the parameters ``p``
    (keyed as ``craft.param_spec``); ``stats`` gets each BatchNorm's batch
    mean and biased variance, keyed by the BatchNorm.  With ``remat`` each
    convolution with what follows it up to the next one (BatchNorm, ReLU,
    pooling) is recomputed in the backward, so that a float64 step at the
    cell's size fits on the card (the values are the same)."""

    def __init__(self, p: dict, remat: bool = False):
        self.p, self.remat, self.stats = p, remat, {}

    def bn(self, key: str, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            self.stats[key] = (x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False))
        return F.batch_norm(x, None, None, self.p[key + ".weight"], self.p[key + ".bias"],
                            training=True, eps=BN_EPS)

    def unit(self, fn, x: torch.Tensor) -> torch.Tensor:
        return checkpoint(fn, x, use_reentrant=False) if self.remat else fn(x)

    def ops(self, name: str, ops: list, x: torch.Tensor) -> torch.Tensor:
        for op in ops:
            if op[0] == "R":
                x = F.relu(x)
            elif op[0] == "P":
                x = F.max_pool2d(x, 2, 2)
            else:
                key = f"basenet.{name}.{op[1]}"
                x = self.bn(f"basenet.{name}.{op[1] + 1}", conv(self.p, key, x, padding=1))
        return x

    def slice(self, name: str, x: torch.Tensor) -> torch.Tensor:
        units = [[]]
        for op in VGG[name]:
            if op[0] == "C" and any(o[0] == "C" for o in units[-1]):
                units.append([])
            units[-1].append(op)
        for ops in units:
            x = self.unit(lambda t, ops=ops: self.ops(name, ops, t), x)
        return x

    def upconv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = self.unit(lambda t: F.relu(self.bn(f"{name}.conv.1", conv(self.p, f"{name}.conv.0", t))), x)
        return self.unit(lambda t: F.relu(self.bn(f"{name}.conv.4", conv(self.p, f"{name}.conv.3", t,
                                                                         padding=1))), x)

    def __call__(self, canvas: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] canvas -> [B, H/2, W/2, 2] scores."""
        x = canvas.permute(0, 3, 1, 2)
        s = {}
        for name in VGG:
            x = self.slice(name, x)
            s[name] = x
        fc = F.max_pool2d(x, 3, 1, 1)
        fc = conv(self.p, "basenet.slice5.1", fc, padding=6, dilation=6)
        fc = conv(self.p, "basenet.slice5.2", fc)
        y = self.upconv("upconv1", torch.cat([fc, s["slice4"]], 1))
        for name, skip in (("upconv2", "slice3"), ("upconv3", "slice2"), ("upconv4", "slice1")):
            t = s[skip]
            y = F.interpolate(y, size=t.shape[2:], mode="bilinear", align_corners=False)
            y = self.upconv(name, torch.cat([y, t], 1))
        for i, _, _, k in HEAD[:-1]:
            y = self.unit(lambda t, i=i, k=k: F.relu(conv(self.p, f"conv_cls.{i}", t, padding=k // 2)), y)
        return conv(self.p, "conv_cls.8", y).permute(0, 2, 3, 1)


def ohem(pred: torch.Tensor, target: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(squared error, positives, hard negatives) of one score map
    [B, H2, W2] against its target."""
    err = (pred - target) ** 2
    pos = target > POS_THRESH
    neg_err = torch.where(pos, torch.zeros_like(err), err).reshape(-1)
    num_pos = pos.sum().clamp_min(1)
    k = (NEG_RATIO * num_pos.float()).int().clamp_max(neg_err.numel() - 1)
    lo, hi = neg_err.min(), neg_err.max()
    for _ in range(HALVINGS):
        mid = 0.5 * (lo + hi)
        above = (neg_err >= mid).sum() > k
        lo, hi = torch.where(above, mid, lo), torch.where(above, hi, mid)
    return err, pos, ~pos & (err >= lo)


def map_loss(pred: torch.Tensor, target: torch.Tensor, positives_only: bool = False):
    """(OHEM-MSE of one map, its count of hard negatives)."""
    err, pos, hard = ohem(pred, target)
    loss = (err * pos).sum() / pos.sum().clamp_min(1)
    if not positives_only:
        loss = loss + (err * hard).sum() / hard.sum().clamp_min(1)
    return loss, hard.sum()


def loss_of(net: Net, batch: dict, variant: str | None = None):
    """(the step's loss, the hard negatives of both maps, the maps)."""
    if variant == "half_batch":
        batch = {k: v[: len(v) // 2] for k, v in batch.items()}
    maps = net(batch["images"])
    only = variant == "positives_only"
    lr_, nr = map_loss(maps[..., 0], batch["region"], only)
    la, na = map_loss(maps[..., 1], batch["affinity"], only)
    return lr_ + la, (0 if only else nr + na), maps


def step(state: dict, batch: dict, variant: str | None = None, remat: bool = False) -> dict:
    """One training step from ``state`` ({params, buffers, adam}; ``adam``
    None for a fresh one) on ``batch`` ({images [B, H, W, 3], region and
    affinity [B, H/2, W/2]}, tensors on the device).  Returns {loss, hard_neg
    (the hard negatives of both maps), maps, grads (clipped), raw_norm,
    params, buffers, adam} after it; the inputs are not changed.  ``remat``
    recomputes the forward in the backward (``Net``)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    keys = list(state["params"])
    params = {k: v.detach().clone().requires_grad_(True) for k, v in state["params"].items()}
    net = Net(params, remat)
    loss, hard, maps = loss_of(net, batch, variant)
    grads = torch.autograd.grad(loss, [params[k] for k in keys])
    with torch.no_grad():
        raw = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).to(grads[0].dtype)
        if raw >= CLIP:
            grads = [g / raw * CLIP for g in grads]
        grads = dict(zip(keys, grads))
        buffers = {}
        for key, (mean, var) in net.stats.items():
            for name, batch_stat in (("running_mean", mean), ("running_var", var)):
                old = state["buffers"][f"{key}.{name}"]
                buffers[f"{key}.{name}"] = (1.0 - MOMENTUM) * old + MOMENTUM * batch_stat
        adam = state.get("adam")
        t = (adam["step"] if adam else 0) + 1
        m_prev = adam["exp_avg"] if adam else {k: torch.zeros_like(g) for k, g in grads.items()}
        v_prev = adam["exp_avg_sq"] if adam else {k: torch.zeros_like(g) for k, g in grads.items()}
        m = {k: BETA1 * m_prev[k] + (1.0 - BETA1) * g for k, g in grads.items()}
        v = {k: BETA2 * v_prev[k] + (1.0 - BETA2) * g * g for k, g in grads.items()}
        c1, c2 = 1.0 - BETA1 ** t, 1.0 - BETA2 ** t
        new = {k: params[k].detach() - LR * (m[k] / c1) / (torch.sqrt(v[k] / c2) + ADAM_EPS) for k in keys}
    return {"loss": loss.detach(), "hard_neg": int(hard), "maps": maps.detach(), "grads": grads, "raw_norm": raw,
            "params": new, "buffers": buffers, "adam": {"step": t, "exp_avg": m, "exp_avg_sq": v}}


def split(sd: dict) -> dict:
    """A state dict as the start of training: {params, buffers, adam None}."""
    return {"params": {k: v for k, v in sd.items() if not is_buffer(k)},
            "buffers": {k: v for k, v in sd.items() if is_buffer(k)}, "adam": None}


def steps(sd: dict, batches: list, variant: str | None = None) -> list:
    """The steps of a fresh state from the state dict ``sd`` over
    ``batches``, each step's result (``step``'s), the state of the last."""
    state, out = split(sd), []
    for b in batches:
        r = step(state, b, variant)
        out.append(r)
        state = {"params": r["params"], "buffers": r["buffers"], "adam": r["adam"]}
    return out


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| in float64."""
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-300))
