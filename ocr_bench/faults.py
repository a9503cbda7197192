"""Faults planted in the program underneath a run, to see that the check
of ``correct`` fails it: each is ``fault(patch)``, where ``patch`` has
pytest's ``MonkeyPatch.setattr``.  The tests plant them at tiny sizes on
the CPU, ``controls.py --fault <name>`` at a cell's own size on the card."""
from __future__ import annotations

import torch


def altered_token(patch) -> None:
    """The first served token of every box replaced after the decoder
    chose it."""
    import lightly_ocr_tpu_torch.serving.batch as batch
    from lightly_ocr_tpu_torch.models import decode

    def decode_crops(net, crops, cfg, lm=None):
        idx, conf = decode.decode_crops(net, crops, cfg, lm)
        idx = idx.clone()
        idx[:, 0] = torch.where(idx[:, 0] == 5, 6, 5)  # a character where the decoder chose another
        return idx, conf
    patch.setattr(batch, "decode_crops", decode_crops)


def wrong_token_fed_back(patch) -> None:
    """Inside the greedy decode loop, at its first step, one box slot in
    four takes its least likely class: the best and the worst scores swap
    places, so the wrong token is both emitted and fed back, and the
    program's logits agree with its tokens."""
    from lightly_ocr_tpu_torch.models import attention

    forward = attention.Attention.forward

    def faulty(self, feats, *args, **kw):
        calls = [0]

        def swap(_module, _args, out):
            calls[0] += 1
            if calls[0] != 1:
                return out
            pick = (torch.arange(out.shape[0], device=out.device) % 4 == 0)[:, None]
            a, b = out.argmax(1, keepdim=True), out.argmin(1, keepdim=True)
            va, vb = out.gather(1, a), out.gather(1, b)
            out = out.clone()
            out.scatter_(1, a, torch.where(pick, vb, va))
            out.scatter_(1, b, torch.where(pick, va, vb))
            return out

        handle = self.generator.register_forward_hook(swap)
        try:
            return forward(self, feats, *args, **kw)
        finally:
            handle.remove()
    patch.setattr(attention.Attention, "forward", faulty)


def half_batch_left_out(patch) -> None:
    """The second half of each dispatch's canvases zeroed before the
    detector."""
    import lightly_ocr_tpu_torch.serving.batch as batch

    prepare = batch.BatchedOCR.prepare

    def halved(self, images, cb, gb):
        canv, gray, inv, ext = prepare(self, images, cb, gb)
        canv[len(images) // 2:] = 0.0
        return canv, gray, inv, ext
    patch.setattr(batch.BatchedOCR, "prepare", halved)


def state_unchanged(patch) -> None:
    """A training step that returns its parameters unchanged."""
    import lightly_ocr_tpu_torch.train.train_step as train_step

    make = train_step.make_train_step

    def make_unchanged(model, cfg, group=None):
        step = make(model, cfg, group)

        def unchanged(state, b):
            saved = [p.detach().clone() for p in model.parameters()]
            state, m = step(state, b)
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved):
                    p.copy_(s)
            return state, m
        return unchanged
    patch.setattr("lightly_ocr_tpu_torch.train.trainer.make_train_step", make_unchanged)


def half_batch_mean(patch) -> None:
    """A training step whose loss is the mean over half of its batch."""
    import lightly_ocr_tpu_torch.train.train_step as train_step

    loss_fn = train_step.loss_fn

    def halved(model, cfg, b, remat=False, group=None):
        n = b["images"].shape[0] // 2
        return loss_fn(model, cfg, {k: v[:n] for k, v in b.items()}, remat, group)
    patch.setattr(train_step, "loss_fn", halved)


SERVING = (altered_token, wrong_token_fed_back, half_batch_left_out)
TRAINING = (state_unchanged, half_batch_mean)
