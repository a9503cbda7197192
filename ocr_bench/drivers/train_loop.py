"""The CRNN trainer's own loop: ``Trainer.fit`` over word records fed by
``data/loader.py::DataLoader`` (its threads, ``keep_ratio``), each batch
through ``train/trainer.py::encode_batch`` and ``Trainer.train_step``
(forward, attention cross entropy, backward, global-norm clip, Adadelta),
and the loss read back each step as ``fit`` does.

Set-up writes the seeded words once as records under ``TMPDIR``, builds the
trainer, loads the seeded weights, and drives the first steps through the
same ``fit`` call; the window then takes over that call, and the benchmark's
feed ends the epoch once the window has closed.  End to end:
``train_samples_per_s``, samples of the steps completed in the window over
its seconds (the window ends with the step that completes past its end).
"""
from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from ocr_bench import gen, weights
from ocr_bench.reference import crnn
from ocr_bench.serving import _span, rec_cfg


def snapshot(trainer, names: list, acc: bool) -> dict:
    """The program's parameters and Adadelta's running squares (and, with
    ``acc``, its running deltas), copied on the device, keyed by name."""
    opt = trainer.state.optimizer
    ps = list(trainer.model.parameters())
    out = {"params": {k: p.detach().clone() for k, p in zip(names, ps)},
           "square_avg": {k: opt.state[p]["square_avg"].detach().clone() for k, p in zip(names, ps)}}
    if acc:
        out["acc_delta"] = {k: opt.state[p]["acc_delta"].detach().clone() for k, p in zip(names, ps)}
    return out


class Feed:
    """The loader as ``Trainer.fit`` iterates it.  Keeps the first ``warm``
    batches and the program's state after them for the check, starts the
    window after them, keeps the state around window step ``check_at`` and
    that step's batch, and ends the epoch once the window has closed."""

    def __init__(self, loader, ctx, trainer, warm: int, check_at: int):
        self.loader, self.dataset = loader, loader.dataset
        self.ctx, self.trainer, self.warm, self.check_at = ctx, trainer, warm, check_at
        self.names = [k for k, _ in trainer.model.named_parameters()]
        self.asked = 0  # batches asked for (= steps completed, plus one)
        self.batches, self.kept = [], {}
        self.window = {"step": check_at}
        self.steps = []  # (asked at, batch in hand at) of each window step
        self.in_window = 0
        self.closed = False
        self.t_end = None

    def __iter__(self):
        """One epoch of ``fit`` that runs until the window closes: where the
        loader's epoch ends, its next begins at once."""
        if self.closed:
            return
        it = iter(self.loader)
        try:
            while True:
                t_ask = time.perf_counter()
                if not self._before(t_ask):
                    return
                try:
                    images, labels = next(it)
                except StopIteration:
                    it.close()
                    it = iter(self.loader)
                    images, labels = next(it)
                if self.ctx.t0 is not None:
                    self.steps.append((t_ask, time.perf_counter()))
                    if self.in_window == self.check_at:
                        self.window["batch"] = (images.copy(), list(labels))
                    self.in_window += 1
                elif len(self.batches) < self.warm:
                    self.batches.append((images.copy(), list(labels)))
                yield images, labels
        finally:
            it.close()  # stops the loader's threads

    def _before(self, now: float) -> bool:
        """Runs as step ``asked`` is asked for (the steps before it have
        completed: ``fit`` reads each loss back); False ends the run."""
        k = self.asked
        self.asked += 1
        opt = self.trainer.state.optimizer
        if k == 1:
            self.kept["square_avg"] = [opt.state[p]["square_avg"].detach().clone()
                                       if "square_avg" in opt.state.get(p, {}) else None
                                       for p in self.trainer.model.parameters()]
        if k == self.warm:
            self.kept["params"] = [p.detach().clone() for p in self.trainer.model.parameters()]
            self.ctx.start_window()
        elif self.ctx.t0 is None:
            return True
        j = k - self.warm  # the window step asked for
        if j == self.check_at:
            self.window["start"] = snapshot(self.trainer, self.names, acc=True)
        elif j == self.check_at + 1:
            after = snapshot(self.trainer, self.names, acc=False)
            self.window["params_after"], self.window["square_avg_after"] = after["params"], after["square_avg"]
        if j == 0:
            return True
        self.ctx.poll()
        if now >= self.ctx.t1:
            self.closed = True
            self.t_end = now
            self.ctx.sleep_until(now)
            return False
        return True


def run(ctx) -> dict:
    from lightly_ocr_tpu_torch.config import Config
    from lightly_ocr_tpu_torch.data.loader import DataLoader
    from lightly_ocr_tpu_torch.data.records import RecordWriter, encode_png, open_dataset
    from lightly_ocr_tpu_torch.train.trainer import Trainer

    from ocr_bench import check_training
    from ocr_bench.counts import flops

    tr, cfgd = ctx.traffic, ctx.config
    work = tempfile.mkdtemp(prefix="ocr_bench_train_")
    cfg = Config.from_dict(cfgd).replace(
        log_dir=os.path.join(work, "logs"), val_interval=1 << 40, save_interval=1 << 40,
        num_iters=1 << 40, num_epochs=1 << 20, seeds=ctx.seed % (1 << 31))
    dev = torch.device(ctx.device)
    rng = np.random.default_rng(ctx.seed)
    font = gen.glyph_font(cfg.character, ctx.seed)
    labels = gen.words(rng, int(tr["words"]), cfg.character, int(tr["min_len"]), int(tr["max_len"]))
    raw = {t: gen.word_image(t, font, rng) for t in labels}
    path = os.path.join(work, "words.lor")
    with RecordWriter(path) as w:
        for t in labels:
            w.add(t, encode_png(raw[t]))
    ds = open_dataset(path, character=cfg.character, batch_max_len=cfg.batch_max_len, rgb=cfg.rgb)
    loader = DataLoader(ds, batch_size=cfg.batch_size, height=cfg.height, width=cfg.width,
                        keep_ratio=cfg.keep_ratio, shuffle=True, seed=ctx.seed, workers=cfg.workers)
    rcfg = rec_cfg(cfg)
    sd = weights.make(crnn.param_spec(rcfg), ctx.seed, dev, crnn.fiducials(cfg.num_fiducial))
    trainer = Trainer(cfg, device=dev)
    trainer.model.load_state_dict(sd, strict=True)
    losses = []  # of the set-up steps, then of the checked window step
    step = trainer.train_step
    warm = int(tr["warm_steps"])
    check_at = int(np.random.default_rng([ctx.seed, 1]).integers(0, int(tr["check_within"])))
    calls = [0]

    def train_step(state, batch):
        state, metrics = step(state, batch)
        if calls[0] < warm or calls[0] == warm + check_at:
            losses.append(metrics["loss"].detach().clone())
        calls[0] += 1
        return state, metrics

    trainer.train_step = _span("ocr_bench.train_step", train_step) if ctx.trace else train_step
    feed = Feed(loader, ctx, trainer, warm, check_at)
    try:
        trainer.fit(feed, None)
    finally:
        ds.close()
    t0, t_end = ctx.t0, feed.t_end
    n = feed.in_window
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    losses = [float(v) for v in losses]
    window = feed.window
    complete = len(feed.batches) == warm and n > 0 and len(losses) == warm + 1 and "params_after" in window
    kept = {"losses": losses[:warm], "square_avg": feed.kept["square_avg"],
            "params": feed.kept["params"], "names": feed.names,
            "window": dict(window, loss=losses[warm] if len(losses) > warm else None)}
    del trainer, feed.trainer, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    nums = check_training.check(kept, feed.batches, raw, sd, rcfg, cfgd) if complete else {}
    control = None
    if ctx.control and complete:  # and the fault of a step that takes the mean over half its batch
        control = {"tf32": check_training.check(kept, feed.batches, raw, sd, rcfg, cfgd, control=True),
                   "half_batch": check_training.check(kept, feed.batches, raw, sd, rcfg, cfgd, halve=True)}
    records = {"window": (t0, t_end), "traced": ctx.traced, "steps": feed.steps,
               "batch": cfg.batch_size}
    if ctx.traced is not None:
        records["flops_per_sample"] = flops.train_per_sample(sd, rcfg, 8)
    shutil.rmtree(work, ignore_errors=True)
    return {"attempted": n, "failed": 0, "memory_peak_bytes": peak, "records": records,
            "numbers": nums, "control": control,
            "e2e": {"train_samples_per_s": n * cfg.batch_size / (t_end - t0)},
            "complete": complete,
            "why_incomplete": f"{len(feed.batches)} of {warm} set-up batches kept, {n} window steps, "
                              f"window step {check_at} kept: {'params_after' in window}"}
