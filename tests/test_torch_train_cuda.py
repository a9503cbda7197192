"""One training step on the card vs the same step on the CPU.

Marked ``cuda``; skips without a CUDA device.  Imports nothing of JAX (the
CPU side is held to the JAX package in ``test_torch_train.py``), so it runs
on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_train_cuda.py

A tiny model (TPS or not, both heads), float32 with TF32 off, from the
same seeded training init.  The loss within 1e-4 relative.  Each
parameter's gradient is held to the CPU's float64 one: the card's
distance (relative L2) within max(1e-3, 4x the CPU float32's own), as
``chip_smoke.py`` phase ``train`` holds the full-width model (float32
rounding alone puts some BatchNorm and TPS gradients 1e-3-1e-2 off the
float64 ones, on either device).  The same step in float64 on the card:
the loss within 1e-10 of the CPU's float64 one, each gradient within
1e-8 (1e-3 in the TPS rectifier, whose grid is float32 in every dtype),
so a fault in the card's step that float32's spread would hide shows
there.  With TPS the card is fed the CPU's
rectified image through a straight-through hook (its own within 1e-4 of
it): the two grids round differently, and this network's gradients move
by percents for such a change of its input.  After one Adam step the
running statistics are within 1e-4 of the CPU's and 99.9% of the weights
within 1e-5 (Adam's first step moves a weight by about its learning rate
whatever its gradient's size, so a gradient near 0 whose sign differs
moves it the other way: at most 2 x lr).
"""
import numpy as np
import pytest
import torch

from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.text.converters import build_converter
from lightly_ocr_tpu_torch.train.train_step import init_train_state, loss_fn, make_train_step

pytestmark = pytest.mark.cuda

_SMALL = dict(output_channel=64, hidden_size=32, height=32, width=100, batch_max_len=8,
              character="abcdefghij", num_fiducial=8, adam=True, lr=1e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _batch(cfg, device):
    labels = ["abc", "de", "fghij", "a", "jj", "bad", "cafe", "h"]
    conv = build_converter(cfg.prediction, cfg.character)
    images = np.random.default_rng(1).uniform(-1, 1, (len(labels), 32, 100, 1)).astype(np.float32)
    if cfg.prediction == "CTC":
        lab, lengths = conv.encode_padded(labels, cfg.batch_max_len)
        batch = {"labels": lab, "lengths": lengths}
    else:
        text, lengths = conv.encode(labels, cfg.batch_max_len)
        batch = {"text": text, "lengths": lengths}
    out = {k: torch.from_numpy(v).long().to(device) for k, v in batch.items()}
    out["images"] = torch.from_numpy(images).to(device)
    return out


@pytest.mark.parametrize("prediction,transform", [("CTC", "None"), ("Attention", "TPS")])
def test_train_step_card_equals_cpu(cuda_device, prediction, transform):
    cfg = Config(prediction=prediction, transform=transform, **_SMALL)
    runs, rect = {}, {}
    for name, dev, dt, ref in (("cpu64", "cpu", torch.float64, None), ("cpu", "cpu", torch.float32, None),
                               ("card", cuda_device, torch.float32, "cpu"),
                               ("card64", cuda_device, torch.float64, "cpu64")):
        model, state = init_train_state(cfg, 0, dev)
        model.to(dt)
        if model.Transformation is not None:
            def feed(m, i, o, name=name, ref=ref):
                rect.setdefault(name, o.detach().cpu())
                if ref is not None:  # the CPU's image, the gradient through the card's TPS
                    return o + (rect[ref].to(o.device) - o).detach()
                return None
            model.Transformation.register_forward_hook(feed)
        batch = _batch(cfg, dev)
        batch["images"] = batch["images"].to(dt)
        loss, _ = loss_fn(model, cfg, batch)
        loss.backward()
        grads = {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()}
        if dt == torch.float32:
            model.zero_grad(set_to_none=True)
            make_train_step(model, cfg)(state, batch)
        runs[name] = (loss.item(), grads, {k: v.cpu() for k, v in model.state_dict().items()})
    (l64, g64, _), (lc, gc, sc), (lg, gg, sg) = runs["cpu64"], runs["cpu"], runs["card"]
    lg64, gg64, _ = runs["card64"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert abs(lg64 - l64) <= 1e-10 * abs(l64)
    for a, b in (("card", "cpu"), ("card64", "cpu64")) if rect else ():
        assert (rect[a] - rect[b]).abs().max() <= 1e-4 * rect[b].abs().max()

    def dist(g, n):
        return ((g[n] - g64[n]).norm() / g64[n].norm().clamp_min(1e-30)).item()

    for n in g64:
        assert dist(gg, n) <= max(1e-3, 4 * dist(gc, n)), (n, dist(gg, n), dist(gc, n))
        assert dist(gg64, n) <= (1e-3 if n.startswith("Transformation.") else 1e-8), (n, dist(gg64, n))
    diffs = []
    for k in sc:
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(sg[k], sc[k], rtol=1e-4, atol=1e-4, msg=k)
        else:
            diffs.append((sg[k] - sc[k]).abs().flatten())
    diffs = torch.cat(diffs)
    assert (diffs <= 1e-5).float().mean() >= 0.999
    assert diffs.max() <= 2 * cfg.lr + 1e-6
