"""The training check: the trainer's first steps, which set-up drives
through the window's own call and feed, and one step of the window,
against the plain reference.

The reference starts from the weights the benchmark made, takes the
batches the program's loader delivered (their images, and their labels,
which it encodes itself), and follows three steps in float32 with TF32
off: forward (batch statistics), ``CrossEntropyLoss(ignore_index=0)``,
backward, the gradient clipped to a global norm of ``grad_clip`` (where
the norm reaches it), Adadelta (Zeiler 2012, with ``lr``).  It then takes
the window step that the driver drew from the seed, from the program's own
state before it (its parameters, Adadelta's running squares and running
deltas) and on the batch that step took.  Numbers:

* ``grad_gap``: the first step's clipped gradient as the optimizer got it,
  worked out from its state after one step (Adadelta's running square is
  (1 - rho) g^2 then): for each leaf the gap between the program's norm and
  the reference's, over the reference's norm of that leaf or of the median
  leaf, whichever is larger; the worst leaf;
* ``update_median``: the same of each leaf's change after the three steps,
  of the median leaf, leaving out leaves whose reference gradient is under
  a thousandth of the median leaf's (they move by round-off alone);
* ``window_loss_gap``: the window step's loss, relative gap;
* ``window_update_gap``: each leaf's change in the window step, the worst
  leaf, leaving out as above and also the leaves whose gradient the
  float32 reference cannot give: its norm departs from a float64
  reference's by over ``ROUNDING`` (the TPS localization network's, whose
  sampling grid sits on the pixel lattice, and BatchNorm scales that the
  next BatchNorm cancels);
* ``loader_levels``: the loader's images (the stage the reference takes
  from the program), each against the word's raw image resized by the
  reference (PIL's bicubic at the word's aspect, right-padded with its last
  column), in 8-bit levels, the widest.

Also read, with no limit: ``loss_gap`` (the three steps' losses, the widest
relative gap), ``update_gap`` (the worst leaf's change after the three
steps), ``window_grad_gap`` (the window step's gradient as Adadelta took
it, from its running square before and after the step, the worst leaf)
and ``window_update_median``.

The control is the reference in TF32 (cuDNN and matmul) in the program's
place; ``halve`` plants the fault of a step that takes the mean over half
of its batch.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ocr_bench.reference import crnn
from ocr_bench.reference.common import float32_exact

GO, EOS = 0, 1
ROUNDING = 0.01  # a leaf's float32 gradient this far off float64's is rounding


def encode(labels: list, charset: str, max_len: int, device) -> torch.Tensor:
    """[B, max_len + 2]: [GO], the characters (2 + index), [s], then 0."""
    out = torch.zeros((len(labels), max_len + 2), dtype=torch.long)
    for i, t in enumerate(labels):
        idx = [2 + charset.index(c) for c in t] + [EOS]
        out[i, 1:1 + len(idx)] = torch.tensor(idx)
    return out.to(device)


def reference_steps(sd: dict, batches: list, rcfg: dict, cfgd: dict, halve: bool = False,
                    start: dict | None = None) -> dict:
    """Reference steps over ``batches`` from the weights ``sd`` and a fresh
    Adadelta state, or from ``start`` ({params, square_avg, acc_delta},
    keyed by parameter name): {losses, grads (first step, clipped), params
    and square_avg after the last step}."""
    dev = next(iter(sd.values())).device
    names = [k for k in sd if "running_" not in k]
    init = start["params"] if start else sd
    params = {k: init[k].detach().clone().requires_grad_(True) for k in names}
    fixed = {k: v for k, v in sd.items() if "running_" in k}
    sq = {k: start["square_avg"][k].clone() if start else torch.zeros_like(v) for k, v in params.items()}
    acc = {k: start["acc_delta"][k].clone() if start else torch.zeros_like(v) for k, v in params.items()}
    rho, eps, lr, clip = cfgd["rho"], cfgd["eps"], cfgd["lr"], cfgd["grad_clip"]
    losses, first = [], None
    for images, labels in batches:
        text = encode(labels, cfgd["character"], cfgd["batch_max_len"], dev)
        x = torch.as_tensor(images, device=dev)
        if halve:
            x, text = x[: len(x) // 2], text[: len(text) // 2]
        net = crnn.CRNN({**params, **fixed}, rcfg, train=True)
        loss = crnn.attention_loss(net.forced_logits(x, text[:, :-1]), text[:, 1:])
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
            if norm >= clip:
                grads = [g / norm * clip for g in grads]
            grads = dict(zip(names, grads))
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            for k, p in params.items():
                g = grads[k]
                sq[k].mul_(rho).addcmul_(g, g, value=1 - rho)
                delta = (acc[k] + eps).sqrt() / (sq[k] + eps).sqrt() * g
                acc[k].mul_(rho).addcmul_(delta, delta, value=1 - rho)
                p.sub_(lr * delta)
        losses.append(float(loss.detach()))
    return {"losses": losses, "grads": first, "params": {k: p.detach() for k, p in params.items()},
            "square_avg": sq}


def leaf_gaps(got: dict, ref: dict, keep=None) -> dict:
    """{leaf: |norm(got) - norm(ref)| over max(norm(ref), the median
    leaf's norm of ref)}."""
    norms = {k: float(v.double().norm()) for k, v in ref.items()}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(got[k].double().norm()) - norms[k]) / max(norms[k], med, 1e-30)
            for k in ref if keep is None or k in keep}


def leaf_gap(got: dict, ref: dict, keep=None) -> tuple[float, str]:
    """(the worst leaf's gap, its name)."""
    gaps = leaf_gaps(got, ref, keep)
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def loader_levels(batches: list, raw: dict, rcfg: dict) -> float:
    """The widest gap, in 8-bit levels, between the loader's images and
    the reference's resize of each word's raw image."""
    from ocr_bench.reference.words import keep_ratio_image

    def levels(x):
        return np.rint((x.astype(np.float64) + 1.0) * 127.5)

    worst = 0.0
    for images, labels in batches:
        for img, t in zip(images, labels):
            ref = keep_ratio_image(raw[t], rcfg["height"], rcfg["width"])
            worst = max(worst, float(np.abs(levels(img[..., 0]) - levels(ref)).max()))
    return worst


def moving_leaves(grads: dict) -> set:
    """The leaves whose reference gradient reaches a thousandth of the
    median leaf's (the others move by round-off alone)."""
    norms = {k: float(v.norm()) for k, v in grads.items()}
    med = float(np.median(list(norms.values())))
    return {k for k, v in norms.items() if v >= 1e-3 * med}


def rounding_leaves(grads32: dict, grads64: dict, tol: float = ROUNDING) -> set:
    """The leaves whose gradient the float32 reference cannot give: its norm
    departs from the float64 reference's by more than ``tol`` (as
    ``leaf_gaps`` measures), as a BatchNorm scale's gradient does where the
    next BatchNorm cancels it."""
    gaps = leaf_gaps({k: v.double() for k, v in grads32.items()}, grads64)
    return {k for k, v in gaps.items() if v > tol}


def as_float64(d: dict) -> dict:
    return {k: v.double() for k, v in d.items()}


def gradient_from_state(after: dict, before: dict, rho: float) -> dict:
    """The gradient as Adadelta took it, from its running square before and
    after the step: |g| = sqrt((after - rho before) / (1 - rho))."""
    return {k: ((after[k] - rho * before[k]) / (1 - rho)).clamp_min(0).sqrt() for k in after}


def finite(x: float) -> float:
    return float(x) if math.isfinite(x) else float("inf")


def check(kept: dict, batches: list, raw: dict, sd: dict, rcfg: dict, cfgd: dict,
          control: bool = False, halve: bool = False) -> dict:
    """{number: value} of the program's first steps and of its window step
    (``kept``), or with ``control`` of the TF32 reference in its place, or
    with ``halve`` of the reference that takes the mean over half of each
    batch."""
    win = kept["window"]
    with float32_exact():
        ref = reference_steps(sd, batches, rcfg, cfgd)
        wref = reference_steps(sd, [win["batch"]], rcfg, cfgd, start=win["start"])
        w64 = reference_steps(as_float64(sd), [win["batch"]], rcfg, cfgd,
                              start={k: as_float64(v) for k, v in win["start"].items()})
    if control or halve:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = control
        try:
            got = reference_steps(sd, batches, rcfg, cfgd, halve=halve)
            wgot = reference_steps(sd, [win["batch"]], rcfg, cfgd, halve=halve, start=win["start"])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        grads, params, losses = got["grads"], got["params"], got["losses"]
        w_grads, w_params, w_loss = wgot["grads"], wgot["params"], wgot["losses"][0]
    else:
        names = kept["names"]
        rho = cfgd["rho"]
        grads = {k: (s / (1 - rho)).sqrt() for k, s in zip(names, kept["square_avg"]) if s is not None}
        missing = [k for k in ref["grads"] if k not in grads]
        grads.update({k: torch.zeros_like(ref["grads"][k]) for k in missing})
        params = dict(zip(names, kept["params"]))
        losses = kept["losses"]
        w_grads = gradient_from_state(win["square_avg_after"], win["start"]["square_avg"], rho)
        w_params, w_loss = win["params_after"], win["loss"]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, ref["losses"]))
    grad_gap, grad_at = leaf_gap(grads, ref["grads"])
    moving = moving_leaves(ref["grads"])
    d_got = {k: params[k] - sd[k] for k in ref["params"]}
    d_ref = {k: ref["params"][k] - sd[k] for k in ref["params"]}
    update_gap, update_at = leaf_gap(d_got, d_ref, moving)
    update_median = float(np.median(list(leaf_gaps(d_got, d_ref, moving).values())))
    # the window step, from the program's own state before it
    w_start = win["start"]["params"]
    noisy = rounding_leaves(wref["grads"], w64["grads"])
    held = set(wref["grads"]) - noisy
    w_moving = moving_leaves(wref["grads"]) & held
    w_grad_gap, w_grad_at = leaf_gap(w_grads, wref["grads"], held)
    wd_got = {k: w_params[k] - w_start[k] for k in wref["params"]}
    wd_ref = {k: wref["params"][k] - w_start[k] for k in wref["params"]}
    w_update_gap, w_update_at = leaf_gap(wd_got, wd_ref, w_moving)
    out = {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap,
           "update_median": update_median,
           "window_loss_gap": abs(w_loss - wref["losses"][0]) / max(abs(wref["losses"][0]), 1e-30),
           "window_grad_gap": w_grad_gap, "window_update_gap": w_update_gap,
           "window_update_median": float(np.median(list(leaf_gaps(wd_got, wd_ref, w_moving).values()))),
           "grad_gap_leaf": grad_at, "update_gap_leaf": update_at,
           "window_grad_gap_leaf": w_grad_at, "window_update_gap_leaf": w_update_at,
           "window_step": win["step"], "left_out": sorted(set(ref["grads"]) - moving),
           "window_left_out": sorted(set(wref["grads"]) - w_moving)}
    if not control and not halve:
        out["loader_levels"] = loader_levels(batches, raw, rcfg)
    for k, v in out.items():
        if isinstance(v, float):
            out[k] = finite(v)
    return out
