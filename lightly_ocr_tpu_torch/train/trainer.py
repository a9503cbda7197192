"""CRNN trainer: train, evaluate, log, checkpoint and resume on one device
(port of ``lightly_ocr_tpu/train/trainer.py``).

    python -m lightly_ocr_tpu_torch.train.trainer --config config.yml \
        --train-root train.lor --val-root val.lor [--num-iters N] [--device cuda]

As the JAX package's trainer (reference ``ocr/train/crnn.py``):

* the loss and optimizer per config (CTC or attention cross entropy, Adam
  or Adadelta, global-norm clip 5; :mod:`.train_step`);
* an eval every ``val_interval`` steps: val loss, exact-match accuracy,
  normalised edit distance, confidences, and a ground truth | prediction |
  confidence | T&F table appended to ``<log_dir>/log_train.txt``;
* best-accuracy checkpoints (``<log_dir>/best_acc``, ``best.json``) and
  periodic ones every ``save_interval`` steps (``<log_dir>/checkpoints``),
  each with the optimizer state and the step; ``saved_model_path`` (a
  checkpoint directory) resumes from its latest step;
* ``log_dataset.txt``, ``log_model.txt`` and ``log_config.txt``.

It runs on the card unless asked otherwise (``device="cpu"``,
``--device cpu``); without a CUDA device the default raises.  The JAX
trainer shards the batch over a device mesh; this one uses one device.
``--model CRAFT`` trains the detector: the other arguments go to
:func:`lightly_ocr_tpu_torch.train.craft.main` (with ``--device``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Sequence

import numpy as np
import torch

from lightly_ocr_tpu_torch.config import Config, load_config
from lightly_ocr_tpu_torch.data.loader import DataLoader
from lightly_ocr_tpu_torch.data.records import open_dataset
from lightly_ocr_tpu_torch.serving.batch import resolve_device
from lightly_ocr_tpu_torch.text.converters import build_converter
from lightly_ocr_tpu_torch.train.train_step import (
    TrainState,
    init_train_state,
    make_eval_step,
    make_train_step,
)
from lightly_ocr_tpu_torch.utils.checkpoint import (
    record_best,
    restore_checkpoint,
    save_checkpoint,
)
from lightly_ocr_tpu_torch.utils.metrics import (
    Averager,
    exact_match_accuracy,
    normalized_edit_distance,
)

DASHED = "-" * 80


def encode_batch(cfg: Config, converter, images: np.ndarray, labels: list[str], device,
                 split: bool = True) -> dict:
    """Host batch -> tensors on ``device``: ``images``, and ``labels`` (CTC,
    padded) or ``text`` (attention, [GO]-prefixed), with ``lengths``.  With
    ``split`` and ``grad_accum`` > 1 every leaf is split into
    ``[grad_accum, B / grad_accum, ...]`` micro-batches, as
    :func:`make_train_step` takes them."""
    if cfg.prediction == "CTC":
        lab, lengths = converter.encode_padded(labels, cfg.batch_max_len)
        arrays = {"labels": lab, "lengths": lengths}
    else:
        text, lengths = converter.encode(labels, cfg.batch_max_len)
        arrays = {"text": text, "lengths": lengths}
    batch = {k: torch.from_numpy(v).long().to(device) for k, v in arrays.items()}
    batch["images"] = torch.from_numpy(np.ascontiguousarray(images)).to(device, non_blocking=True)
    accum = max(1, int(cfg.grad_accum))
    if split and accum > 1:
        if len(images) % accum:
            raise ValueError(f"batch of {len(images)} does not split into "
                             f"grad_accum={accum} micro-batches")
        batch = {k: v.reshape(accum, -1, *v.shape[1:]) for k, v in batch.items()}
    return batch


class Trainer:
    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = resolve_device("cuda" if device is None else device)
        self.converter = build_converter(cfg.prediction, cfg.character)
        self.model, self.state = init_train_state(cfg, cfg.seeds, self.device)
        self.train_step = make_train_step(self.model, cfg)
        self.eval_step = make_eval_step(self.model, cfg)
        os.makedirs(cfg.log_dir, exist_ok=True)
        self.best_acc = -1.0
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "host"
        print(f"training on device {self.device} ({name})", flush=True)

    # ------------------------------------------------------------------
    def _log(self, fname: str, text: str) -> None:
        with open(os.path.join(self.cfg.log_dir, fname), "a") as f:
            f.write(text + "\n")

    def log_startup(self, train_len: int) -> None:
        cfg = self.cfg
        self._log(
            "log_dataset.txt",
            f"{DASHED}\ndataset_root:{cfg.train_root}\n"
            f"batch_size:{cfg.batch_size}\nnum_samples:{train_len}",
        )
        self._log(
            "log_model.txt",
            f"model input params:\nheight:{cfg.height}\nwidth:{cfg.width}\n"
            f"fiducial points:{cfg.num_fiducial}\n"
            f"input channel:{cfg.derived_input_channel}\n"
            f"output channel:{cfg.output_channel}\n"
            f"hidden size:{cfg.hidden_size}\n"
            f"num class:{cfg.derived_num_classes}\n"
            f"batch_max_len:{cfg.batch_max_len}\n"
            f"structure:{cfg.transform}-{cfg.backbone}-{cfg.sequence}-"
            f"{cfg.prediction}",
        )
        options = "------------------Options------------------\n"
        for k, v in cfg.to_dict().items():
            options += f"{k}: {v}\n"
        options += "-------------------------------------------"
        self._log("log_config.txt", options)

    # ------------------------------------------------------------------
    def decode_preds(self, idx: np.ndarray) -> list[str]:
        if self.cfg.prediction == "CTC":
            return self.converter.decode_padded(idx)
        return self.converter.decode_trimmed(idx)

    # ------------------------------------------------------------------
    def evaluate(self, val_loader) -> dict:
        cfg = self.cfg
        avg_loss = Averager()
        preds_all, labels_all, confs_all = [], [], []
        infer_s = 0.0
        for i, (images, labels) in enumerate(val_loader):
            if i >= cfg.max_iter:
                break
            batch = encode_batch(cfg, self.converter, images, labels, self.device, split=False)
            t0 = time.perf_counter()
            out = self.eval_step(self.state, batch)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            infer_s += time.perf_counter() - t0
            avg_loss.add(out["loss"])
            preds_all.extend(self.decode_preds(out["pred_idx"]))
            labels_all.extend(labels)
            confs_all.extend(out["confidence"].tolist())
        acc = exact_match_accuracy(preds_all, labels_all)
        ned = normalized_edit_distance(preds_all, labels_all)
        return {
            "loss": avg_loss.val(),
            "accuracy": acc,
            "norm_ED": ned,
            "preds": preds_all,
            "labels": labels_all,
            "confidence": confs_all,
            "infer_s": infer_s,
            "len_data": len(labels_all),
        }

    def log_eval(self, step: int, train_loss: float, ev: dict,
                 elapsed: float) -> None:
        cfg = self.cfg
        lines = [
            f"[{step}/{cfg.num_iters}] train_loss: {train_loss:0.5f} | "
            f"val_loss: {ev['loss']:0.5f} | elapsed time: {elapsed:0.5f}",
            f"{'accuracy':20s}: {ev['accuracy']:0.3f}",
            f"{'norm_ED':20s}: {ev['norm_ED']:0.3f}",
            f"{'best accuracy':20s}: {self.best_acc:0.3f}",
            DASHED,
            f"{'ground truth':20s} | {'prediction':20s} | confidence | T&F",
            DASHED,
        ]
        for gt, pred, conf in list(
            zip(ev["labels"], ev["preds"], ev["confidence"])
        )[:10]:
            lines.append(
                f"{gt:20s} | {pred:20s} | {conf:0.4f} | {str(pred == gt)}"
            )
        lines.append(DASHED)
        text = "\n".join(lines)
        print(text, flush=True)
        self._log("log_train.txt", text)

    # ------------------------------------------------------------------
    def maybe_resume(self) -> None:
        cfg = self.cfg
        if cfg.saved_model_path:
            self.state, step = restore_checkpoint(cfg.saved_model_path, self.state)
            print(f"resumed from {cfg.saved_model_path} at step {step}")

    def fit(self, train_loader, val_loader) -> TrainState:
        cfg = self.cfg
        self.log_startup(len(train_loader.dataset))
        self.maybe_resume()
        avg_loss = Averager()
        start = time.time()
        i = self.state.step
        done = False
        for epoch in range(cfg.num_epochs):
            if done:
                break
            for images, labels in train_loader:
                batch = encode_batch(cfg, self.converter, images, labels, self.device)
                self.state, metrics = self.train_step(self.state, batch)
                avg_loss.add(metrics["loss"].item())
                i += 1

                if i % cfg.val_interval == 0:
                    ev = self.evaluate(val_loader)
                    if ev["accuracy"] > self.best_acc:
                        self.best_acc = ev["accuracy"]
                        if record_best(cfg.log_dir, i, ev["accuracy"]):
                            save_checkpoint(os.path.join(cfg.log_dir, "best_acc"),
                                            i, self.state)
                    self.log_eval(i, avg_loss.val(), ev, time.time() - start)
                    avg_loss.reset()

                if i % cfg.save_interval == 0:
                    save_checkpoint(os.path.join(cfg.log_dir, "checkpoints"), i, self.state)
                if i >= cfg.num_iters:
                    print("Stop training here.")
                    done = True
                    break
        return self.state


def build_loaders(cfg: Config, seed: int | None = None):
    kw = dict(character=cfg.character if cfg.filtering else None,
              batch_max_len=cfg.batch_max_len, rgb=cfg.rgb)
    seed = cfg.seeds if seed is None else seed
    train_loader = DataLoader(
        open_dataset(cfg.train_root, **kw), batch_size=cfg.batch_size,
        height=cfg.height, width=cfg.width, keep_ratio=cfg.keep_ratio,
        shuffle=True, seed=seed, workers=cfg.workers,
    )
    val_loader = DataLoader(
        open_dataset(cfg.val_root, **kw), batch_size=cfg.batch_size,
        height=cfg.height, width=cfg.width, keep_ratio=False,
        shuffle=True, seed=seed, workers=cfg.workers,
    )
    return train_loader, val_loader


def main(argv: Sequence[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="CRNN / CRAFT training")
    p.add_argument("--model", default="CRNN", choices=["CRNN", "CRAFT"],
                   help="CRAFT = detector score-map training "
                        "(lightly_ocr_tpu_torch.train.craft); extra args pass "
                        "through to its CLI")
    p.add_argument("--config", default=None)
    p.add_argument("--train-root", default=None)
    p.add_argument("--val-root", default=None)
    p.add_argument("--num-iters", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the CPU only when asked)")
    args, extra = p.parse_known_args(argv)
    if args.model == "CRAFT":
        from lightly_ocr_tpu_torch.train.craft import main as craft_main

        return craft_main([*extra, "--device", args.device])
    if extra:
        p.error(f"unrecognized arguments: {' '.join(extra)}")
    cfg = load_config(args.config)
    overrides = {
        k: v
        for k, v in {
            "train_root": args.train_root,
            "val_root": args.val_root,
            "num_iters": args.num_iters,
        }.items()
        if v is not None
    }
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    trainer = Trainer(cfg, device=args.device)
    train_loader, val_loader = build_loaders(cfg)
    trainer.fit(train_loader, val_loader)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
