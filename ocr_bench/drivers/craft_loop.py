"""The CRAFT trainer's own loop: ``train/craft.py``'s ``fit_craft`` over
``craft_batches`` (synthetic receipts with exact gaussian targets, drawn on
the step's thread from ``np.random.default_rng(seed)``), each batch uploaded
by ``batch_to`` and stepped by ``make_craft_train_step`` (forward in
training mode, OHEM-MSE of both maps, backward, global-norm clip, Adam),
with the losses kept on the device and read back at ``fit_craft``'s log
points only.

Set-up makes the seeded weights, loads them into ``init_craft_state``'s
model, makes the step, and drives the first ``warm_steps`` steps through
the same ``fit_craft`` call; the window then takes over that call, and the
benchmark's feed (which wraps ``craft_batches`` as ``train_loop``'s wraps
the loader) ends it once the window has closed.  ``fit_craft`` does not wait
for a step, so the feed waits for the card once before the window starts and
once at the first ask past its end.  End to end: ``train_samples_per_s``,
samples of the steps completed in the window over its seconds (the window
ends with the step that completes past its end).

For the check the feed keeps on the device Adam's first moment after the
first step, and around window step ``check_at`` (drawn from the seed) the
parameters, running statistics and Adam's state before it and the
parameters, running statistics and first moment after it; a forward hook
keeps that step's score maps, whose hard negatives the program's own
``ohem_masks`` counts after the run.  The host batches of the set-up steps
and of that step are kept too.
"""
from __future__ import annotations

import gc
import itertools
import sys
import time

import numpy as np
import torch

from ocr_bench import weights
from ocr_bench.reference import craft


def snapshot(model, optimizer, full: bool) -> dict:
    """Device copies, keyed by name, of the parameters, the running
    statistics and Adam's first moment, and with ``full`` Adam's second
    moment and step too, as the reference takes a state."""
    named = list(model.named_parameters())
    state = optimizer.state
    out = {"params": {k: p.detach().clone() for k, p in named},
           "buffers": {k: b.detach().clone() for k, b in model.named_buffers()},
           "exp_avg": {k: state[p]["exp_avg"].detach().clone() for k, p in named}}
    if full:
        out["adam"] = {"step": int(state[named[0][1]]["step"]), "exp_avg": out.pop("exp_avg"),
                       "exp_avg_sq": {k: state[p]["exp_avg_sq"].detach().clone() for k, p in named}}
    return out


def wait_for(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Feed:
    """``craft_batches`` as ``fit_craft`` iterates it.  Keeps the first
    ``warm`` batches, Adam's first moment after the first step, starts the
    window after the set-up steps, keeps the state around window step
    ``check_at`` and that step's batch, and ends the run once the window has
    closed."""

    def __init__(self, batches, ctx, model, optimizer, warm: int, check_at: int, device):
        self.batches, self.ctx, self.model, self.opt = batches, ctx, model, optimizer
        self.warm, self.check_at, self.device = warm, check_at, device
        self.setup, self.kept = [], {}
        self.window = {"step": check_at}
        self.steps = []  # (asked at, batch in hand at) of each window step
        self.in_window = 0
        self.t_end = None

    def __iter__(self):
        for k in itertools.count():  # k: the steps enqueued before this ask
            t_ask = time.perf_counter()
            if not self._before(k, t_ask):
                return
            data = next(self.batches)
            if self.ctx.t0 is not None:
                self.steps.append((t_ask, time.perf_counter()))
                if self.in_window == self.check_at:
                    self.window["batch"] = data
                self.in_window += 1
            else:
                self.setup.append(data)
            yield data

    def _before(self, k: int, now: float) -> bool:
        """Runs as step ``k`` is asked for; False ends the run."""
        if k == 1:
            self.kept["exp_avg1"] = {n: self.opt.state[p]["exp_avg"].detach().clone()
                                     for n, p in self.model.named_parameters()}
        if k == self.warm:
            wait_for(self.device)
            self.ctx.start_window()
        elif self.ctx.t0 is None:
            return True
        j = k - self.warm  # the window step asked for
        if j == self.check_at:
            self.window["start"] = snapshot(self.model, self.opt, full=True)
        elif j == self.check_at + 1:
            self.window["after"] = snapshot(self.model, self.opt, full=False)
        if j == 0:
            return True
        self.ctx.poll()
        if now >= self.ctx.t1:
            wait_for(self.device)
            self.t_end = time.perf_counter()
            self.ctx.sleep_until(now)
            return False
        return True


def run(ctx) -> dict:
    from lightly_ocr_tpu_torch.train.craft import (
        craft_batches,
        fit_craft,
        init_craft_state,
        make_craft_train_step,
        ohem_masks,
    )

    from ocr_bench import check_craft_training
    from ocr_bench.counts import craft_train as counts

    tr, cfgd = ctx.traffic, ctx.config
    batch, height, width = int(tr["batch"]), int(tr["height"]), int(tr["width"])
    dev = torch.device(ctx.device)
    sd = weights.make(craft.param_spec(), ctx.seed, dev)
    model, state = init_craft_state(ctx.seed, float(cfgd["lr"]), dev, freeze=tuple(cfgd["freeze"]))
    model.load_state_dict(sd, strict=True)
    step = make_craft_train_step(model, clip=float(cfgd["grad_clip"]), freeze=tuple(cfgd["freeze"]))
    warm = int(tr["warm_steps"])
    check_at = int(np.random.default_rng([ctx.seed, 1]).integers(0, int(tr["check_within"])))
    maps, calls = {}, [0]

    def keep_maps(_module, _args, out):
        if calls[0] == warm + check_at:
            maps["window"] = out[0].detach().float().clone()
        calls[0] += 1

    hook = model.register_forward_hook(keep_maps)
    batches = craft_batches(np.random.default_rng(ctx.seed), batch, height, width,
                            max_words=int(tr["max_words"]))
    feed = Feed(batches, ctx, model, state.optimizer, warm, check_at, dev)
    losses = fit_craft(state, step, feed, dev, log_every=int(tr["log_every"]),
                       log_fn=lambda line: print(line, file=sys.stderr, flush=True))
    hook.remove()
    t0, t_end, n = ctx.t0, feed.t_end, feed.in_window
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window = feed.window
    complete = (len(feed.setup) == warm and len(losses) > warm + check_at and "after" in window
                and "window" in maps and t_end is not None)
    kept = None
    if complete:
        with torch.no_grad():
            b = check_craft_training.on_device(window["batch"], dev)
            m = maps.pop("window")
            hard = sum(int(ohem_masks(m[..., c], b[key][: len(m)])[2].sum())
                       for c, key in ((0, "region"), (1, "affinity")))
        kept = {"losses": [float(v) for v in losses[:warm]], "exp_avg1": feed.kept["exp_avg1"],
                "window": dict(window, loss=float(losses[warm + check_at]), hard_neg=hard)}
    del model, state, step, losses, feed.model, feed.opt, maps
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    nums, control = ({}, None)
    if complete:
        nums, control = check_craft_training.check(kept, feed.setup, sd, controls=ctx.control)
    records = {"window": (t0, t_end), "traced": ctx.traced, "steps": feed.steps, "batch": batch}
    if ctx.traced is not None:
        records["flops_per_sample"] = counts.train_per_sample(height, width)
    return {"attempted": n, "failed": 0, "memory_peak_bytes": peak, "records": records,
            "numbers": nums, "control": control,
            "e2e": {"train_samples_per_s": n * batch / (t_end - t0) if t_end else float("nan")},
            "complete": complete,
            "why_incomplete": f"{len(feed.setup)} of {warm} set-up batches kept, {n} window steps, "
                              f"window step {check_at} kept: {'after' in window}"}
