"""Training checkpoints in PyTorch's own format (the port's counterpart of
``lightly_ocr_tpu/utils/checkpoint.py``, which uses orbax).

Layout: ``<directory>/<step>/state.pt`` holding ``{"model": state dict in
the reference's key names, "optimizer": optimizer state dict, "step":
int}``; the ``max_to_keep`` latest steps stay.  ``best.json`` beside them
tracks the best eval metric.  As the JAX package's: a step saved again
replaces the old one safely (renamed aside, the new one saved, then the
old one deleted; a save that fails puts the old one back), and the
optimizer state and the step are kept, which the reference's bare
``torch.save(state_dict)`` files (``ocr/train/crnn.py:300-302``) dropped.

A model sharded over a model axis (:func:`~lightly_ocr_tpu_torch.parallel.
tensor.shard_module`) is saved whole: every rank of its model group calls
:func:`save_checkpoint`, which gathers the full model and optimizer state
(the file a one-process run writes), and model index 0 writes it.
:func:`restore_checkpoint` cuts a full file to the state's slices, so a
checkpoint moves between model axes of any size.
"""
from __future__ import annotations

import json
import os
import shutil

import torch

from lightly_ocr_tpu_torch.parallel.tensor import (
    full_optimizer_state,
    full_state_dict,
    model_shards,
    shard_optimizer_state,
    shard_state_dict,
)

STATE_FILE = "state.pt"


def _steps(root: str) -> list[int]:
    """The saved steps under ``root``, ascending."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.isdigit() and os.path.isfile(os.path.join(root, name, STATE_FILE)):
            out.append(int(name))
    return sorted(out)


def save_checkpoint(directory: str, step: int, state, max_to_keep: int = 5) -> None:
    """Save ``state`` (a :class:`~lightly_ocr_tpu_torch.train.train_step.
    TrainState`) as ``step``.  The file is written into ``<step>.tmp`` and
    renamed into place, so a step directory is always whole.  A sharded
    model's ranks call it together (module docstring); only model index 0
    writes."""
    payload = {"model": full_state_dict(state.model),
               "optimizer": full_optimizer_state(state.optimizer, state.model),
               "step": int(step)}
    if model_shards(state.model) and state.model.mesh_groups.model_index != 0:
        return
    root = os.path.abspath(directory)
    os.makedirs(root, exist_ok=True)
    target = os.path.join(root, str(step))
    tmp = target + ".tmp"
    backup = None
    if os.path.exists(target):
        backup = os.path.join(root, f"replaced.{step}.bak")
        if os.path.exists(backup):
            shutil.rmtree(backup)
        os.rename(target, backup)
    try:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        os.rename(tmp, target)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        if backup is not None and not os.path.exists(target):  # put the old state back
            os.rename(backup, target)
        raise
    if backup is not None:
        shutil.rmtree(backup)
    for old in _steps(root)[:-max_to_keep]:
        shutil.rmtree(os.path.join(root, str(old)))


def latest_step(directory: str) -> int | None:
    steps = _steps(os.path.abspath(directory))
    return steps[-1] if steps else None


def load_state_file(directory: str, step: int | None = None) -> tuple[dict, int]:
    """-> (the saved dict, on the CPU; its step): ``step``, or the latest."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(os.path.abspath(directory), str(step), STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True), step


def restore_checkpoint(directory: str, state, step: int | None = None):
    """Load a checkpoint into ``state`` (its model and optimizer, on their
    devices; a sharded model takes its slices) and set its step; returns
    (state, step)."""
    saved, step = load_state_file(directory, step)
    state.model.load_state_dict(shard_state_dict(state.model, saved["model"]), strict=True)
    state.optimizer.load_state_dict(
        shard_optimizer_state(state.optimizer, state.model, saved["optimizer"]))
    state.step = int(saved["step"])
    return state, step


def load_variables_for_inference(directory: str, step: int | None = None) -> dict:
    """The model state dict of a checkpoint (reference key names, float32 on
    the CPU), as ``engines.CRNN(state_dict=...)`` loads it with
    ``strict=True``."""
    return load_state_file(directory, step)[0]["model"]


def record_best(directory: str, step: int, metric: float) -> bool:
    """Track the best eval metric in ``best.json``; True if ``metric`` is a
    new best (the caller then saves)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "best.json")
    best = None
    if os.path.isfile(path):
        with open(path) as f:
            best = json.load(f)
    if best is None or metric > best["metric"]:
        with open(path, "w") as f:
            json.dump({"step": step, "metric": metric}, f)
        return True
    return False
