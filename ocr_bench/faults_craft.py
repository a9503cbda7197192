"""Faults planted in the CRAFT training step underneath a run, to see that
the check of ``correct`` fails it: each is ``fault(patch)``, as in
``faults.py``, and named as the CRNN step's fault it mirrors."""
from __future__ import annotations

import torch


def state_unchanged(patch) -> None:
    """A CRAFT training step that returns its parameters unchanged."""
    import lightly_ocr_tpu_torch.train.craft as craft

    make = craft.make_craft_train_step

    def make_unchanged(model, *args, **kw):
        step = make(model, *args, **kw)

        def unchanged(state, b):
            saved = [p.detach().clone() for p in model.parameters()]
            state, m = step(state, b)
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved):
                    p.copy_(s)
            return state, m
        return unchanged
    patch.setattr(craft, "make_craft_train_step", make_unchanged)


def half_batch_mean(patch) -> None:
    """A CRAFT training step whose loss is that of the first half of its
    batch."""
    import lightly_ocr_tpu_torch.train.craft as craft

    loss = craft.craft_loss

    def halved(model, batch, group=None):
        n = batch["images"].shape[0] // 2
        return loss(model, {k: v[:n] for k, v in batch.items()}, group)
    patch.setattr(craft, "craft_loss", halved)


TRAINING = (state_unchanged, half_batch_mean)


def also_in_craft(fault):
    """``fault`` of ``faults.TRAINING`` planted together with the CRAFT
    fault of its name, under its name."""
    twin = {f.__name__: f for f in TRAINING}[fault.__name__]

    def both(patch) -> None:
        fault(patch)
        twin(patch)
    both.__name__ = fault.__name__
    return both
