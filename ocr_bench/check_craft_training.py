"""The check of the CRAFT training cell: the trainer's first steps, which
set-up drives through the window's own ``fit_craft`` call, and one step of
the window, against the plain reference (``reference/craft_train.py``).

The reference starts from the weights the benchmark made and follows the
three set-up steps on the program's own batches, in float32 with TF32 off.
It then takes the window step that the driver drew from the seed, from the
program's own state before it (parameters, BatchNorm running statistics,
Adam's moments and step) and on that step's batch.  The program is freed
first.

Gradients are compared, not parameter updates: Adam's first updates are
about ``lr * sign(g)``, so a gradient near zero that rounds the other way
flips a whole update.  The program's clipped gradient is read from Adam's
first moment, ``(exp_avg_after - 0.9 * exp_avg_before) / 0.1``.  Numbers:

* ``first_loss_gap``: the first set-up step's loss (the benchmark's
  weights, the program's first batch), relative gap;
* ``window_loss_gap``: the window step's loss, relative gap;
* ``update_norm_gap``: the norm of the change of all parameters in the
  window step, relative gap (a state left unchanged reads 1);
* ``grad_gap``, ``window_grad_gap``: the first and the window step's
  clipped gradient, the worst leaf's relative L2 gap.  Left out are the
  leaves whose gradient float32 cannot resolve, by ``check_training.
  ROUNDING``'s rule: the float32 reference's gradient of the leaf departs
  from a float64 reference's (``remat``, so that it fits on the card) by more
  than ``ROUNDING``.  They are the biases of the convolutions whose output
  reaches a training-mode BatchNorm through linear operations alone, whose
  true gradient is 0 (the BatchNorm takes the mean away), and round-off is
  all that is left of it;
* ``stats_gap``: every BatchNorm running statistic after the window step,
  the worst tensor's relative L2 gap;
* ``hard_neg_gap``: the window step's hard negatives of both maps, counted
  by the program's own OHEM on its own maps, against the reference's,
  relative.

Also read, with no limit: ``loss_gap``, the three set-up losses, the
widest relative gap.  After the first step the two run apart by Adam's
``lr * sign(g)`` on gradients near zero, by as much as TF32 moves them;
the first step starts both from the same state and is held by
``first_loss_gap``.

The control is the reference in TF32 (cuDNN and matmuls) in the program's
place; the faults are the reference variants ``half_batch`` and
``positives_only`` in its place.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ocr_bench.check_training import ROUNDING
from ocr_bench.reference import craft_train as ref
from ocr_bench.reference.craft_train import rel_l2

BETA1 = ref.BETA1


def on_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32), device=device) for k, v in batch.items()}


def as_float64(state: dict) -> dict:
    """A reference state ({params, buffers, adam}) in float64."""
    adam = state.get("adam")
    return {"params": {k: v.double() for k, v in state["params"].items()},
            "buffers": {k: v.double() for k, v in state["buffers"].items()},
            "adam": adam and {"step": adam["step"], "exp_avg": {k: v.double() for k, v in adam["exp_avg"].items()},
                              "exp_avg_sq": {k: v.double() for k, v in adam["exp_avg_sq"].items()}}}


def float64_grads(state: dict, batch: dict) -> dict:
    """The clipped gradient of a float64 reference step (recomputing)."""
    with ref.precision(False):
        return ref.step(as_float64(state), {k: v.double() for k, v in batch.items()}, remat=True)["grads"]


def gradient_from_adam(after: dict, before: dict | None) -> dict:
    """The gradient Adam took, from its first moment before and after the
    step (``before`` None: a fresh state)."""
    return {k: (a - (0.0 if before is None else BETA1 * before[k])) / (1.0 - BETA1) for k, a in after.items()}


def rounding_leaves(grads32: dict, grads64: dict, tol: float = ROUNDING) -> set:
    """The leaves whose float32 reference gradient departs from the float64
    reference's by more than ``tol`` (relative L2)."""
    return {k for k in grads32 if rel_l2(grads32[k], grads64[k]) > tol}


def finite(x: float) -> float:
    return float(x) if math.isfinite(x) else float("inf")


def worst(got: dict, want: dict, keep) -> tuple[float, str]:
    """(the worst leaf's relative L2 gap over ``keep``, its name; a gap
    that is not finite is the worst)."""
    gaps = {k: finite(rel_l2(got[k], want[k])) for k in want if k in keep}
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def reference(kept: dict, batches: list, sd: dict) -> dict:
    """The float32 reference: the set-up steps from ``sd`` and the window
    step from the program's state; the leaves float32 cannot resolve in the
    first and in the window step, by float64 references of both."""
    dev = next(iter(sd.values())).device
    win = kept["window"]
    setup = [on_device(b, dev) for b in batches]
    wbatch = on_device(win["batch"], dev)
    with ref.precision(False):
        first = ref.steps(sd, setup)
        window = ref.step(win["start"], wbatch)
    noisy = rounding_leaves(first[0]["grads"], float64_grads(ref.split(sd), setup[0]))
    w_noisy = rounding_leaves(window["grads"], float64_grads(win["start"], wbatch))
    return {"setup": setup, "wbatch": wbatch, "losses": [float(r["loss"]) for r in first],
            "grads": first[0]["grads"], "noisy": noisy, "window": window, "w_noisy": w_noisy}


def substitute(kept: dict, r: dict, sd: dict, control: bool = False, variant: str | None = None) -> dict:
    """What the program's place holds under the TF32 control or a fault
    variant: its losses, gradients, running statistics and hard negatives."""
    with ref.precision(control):
        got = ref.steps(sd, r["setup"], variant)
        w = ref.step(kept["window"]["start"], r["wbatch"], variant)
    return {"losses": [float(g["loss"]) for g in got], "grads": got[0]["grads"],
            "w_loss": float(w["loss"]), "w_grads": w["grads"], "w_buffers": w["buffers"],
            "w_params": w["params"], "w_hard_neg": w["hard_neg"]}


def program(kept: dict) -> dict:
    """The program's own numbers, from what the driver kept."""
    win = kept["window"]
    return {"losses": kept["losses"], "grads": gradient_from_adam(kept["exp_avg1"], None),
            "w_loss": win["loss"], "w_grads": gradient_from_adam(win["after"]["exp_avg"],
                                                                 win["start"]["adam"]["exp_avg"]),
            "w_buffers": win["after"]["buffers"], "w_params": win["after"]["params"],
            "w_hard_neg": win["hard_neg"]}


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def change_norm(after: dict, before: dict) -> float:
    """The norm of the change of all parameters, in float64."""
    return float(torch.sqrt(sum(((after[k].double() - before[k].double()) ** 2).sum() for k in before)))


def numbers(got: dict, r: dict, start: dict, window_step: int) -> dict:
    w = r["window"]
    moved = change_norm(w["params"], start)
    keep = set(r["grads"]) - r["noisy"]
    w_keep = set(w["grads"]) - r["w_noisy"]
    grad_gap, grad_at = worst(got["grads"], r["grads"], keep)
    w_grad_gap, w_grad_at = worst(got["w_grads"], w["grads"], w_keep)
    stats_gap, stats_at = worst(got["w_buffers"], w["buffers"], set(w["buffers"]))
    out = {"first_loss_gap": rel_gap(got["losses"][0], r["losses"][0]),
           "loss_gap": max(rel_gap(a, b) for a, b in zip(got["losses"], r["losses"])),
           "window_loss_gap": rel_gap(got["w_loss"], float(w["loss"])),
           "grad_gap": grad_gap, "window_grad_gap": w_grad_gap, "stats_gap": stats_gap,
           "update_norm_gap": rel_gap(change_norm(got["w_params"], start), moved),
           "hard_neg_gap": abs(got["w_hard_neg"] - w["hard_neg"]) / max(w["hard_neg"], 1),
           "grad_gap_leaf": grad_at, "window_grad_gap_leaf": w_grad_at, "stats_gap_leaf": stats_at,
           "hard_neg": got["w_hard_neg"], "hard_neg_reference": w["hard_neg"],
           "losses": got["losses"], "reference_losses": r["losses"], "window_step": window_step,
           "rounding_leaves": sorted(r["noisy"]), "window_rounding_leaves": sorted(r["w_noisy"])}
    for k, v in out.items():
        if isinstance(v, float):
            out[k] = finite(v)
    return out


def check(kept: dict, batches: list, sd: dict, controls: bool = False) -> tuple[dict, dict | None]:
    """({number: value} of the program's set-up steps and window step
    (``kept``), and with ``controls`` {"tf32", "half_batch",
    "positives_only": the same numbers of each in the program's place}, or
    None)."""
    r = reference(kept, batches, sd)
    win = kept["window"]
    at = (win["start"]["params"], win["step"])
    nums = numbers(program(kept), r, *at)
    if not controls:
        return nums, None
    return nums, {"tf32": numbers(substitute(kept, r, sd, control=True), r, *at),
                  "half_batch": numbers(substitute(kept, r, sd, variant="half_batch"), r, *at),
                  "positives_only": numbers(substitute(kept, r, sd, variant="positives_only"), r, *at)}
