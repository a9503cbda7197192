"""One CRAFT training step on the card vs the same step on the CPU.

Marked ``cuda``; skips without a CUDA device.  Imports nothing of JAX (the
CPU side is held to the JAX package in ``test_torch_craft.py``), so it runs
on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_craft_cuda.py

``VGG_UNet`` from ``init_craft_state``'s seeded init, b2 at 64x64, in
float64 on both sides: the loss within 1e-10 relative, each gradient
within 1e-8 relative L2 (a gradient that is zero in exact arithmetic, the
bias of a conv that feeds a BatchNorm, within 1e-12 of the global norm),
the OHEM masks equal, and the state after one ``make_craft_train_step``
step (Adam, the freeze of slice1) within 1e-8.  OHEM runs on the card with
no host sync (``torch.cuda.set_sync_debug_mode("error")``).
"""
import numpy as np
import pytest
import torch

from lightly_ocr_tpu_torch.train.craft import (
    batch_to,
    craft_loss,
    init_craft_state,
    make_craft_train_step,
    ohem_masks,
    ohem_mse,
    synthesize_batch,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm().clamp_min(1e-300)).item()


def test_craft_step_float64_card_vs_cpu(cuda_device):
    host = synthesize_batch(np.random.default_rng(0), 2, 64, 64)
    runs = {}
    for dev in ("cpu", cuda_device):
        model, state = init_craft_state(0, device=dev)
        model.double()
        b = batch_to(host, dev)
        b["images"] = b["images"].double()
        loss = craft_loss(model, b)
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
        with torch.no_grad():
            maps, _ = model.eval()(b["images"])
        masks = [m.cpu() for i, k in enumerate(("region", "affinity"))
                 for m in ohem_masks(maps[..., i], b[k])[1:]]
        model2, state2 = init_craft_state(0, device=dev)
        model2.double()
        make_craft_train_step(model2, freeze=("slice1",))(state2, b)
        runs[str(dev)] = (loss.item(), grads, masks, {k: v.cpu() for k, v in model2.state_dict().items()})
    (l_cpu, g_cpu, m_cpu, s_cpu), (l_card, g_card, m_card, s_card) = runs["cpu"], runs["cuda"]
    assert abs(l_card - l_cpu) <= 1e-10 * abs(l_cpu)
    total = torch.stack([g.norm() for g in g_cpu.values()]).norm()
    for n, g in g_cpu.items():
        if g.norm() < 1e-12 * total:
            assert g_card[n].norm() < 1e-12 * total, n
        else:
            assert _rel(g_card[n], g) <= 1e-8, n
    for a, b in zip(m_card, m_cpu):
        assert torch.equal(a, b)
    for k, v in s_cpu.items():
        if v.abs().max() < 1e-9:  # a zero-gradient bias moved by Adam's round-off
            assert s_card[k].abs().max() < 1e-9, k
        else:
            assert _rel(s_card[k], v) <= 1e-8, k


def test_ohem_has_no_host_sync(cuda_device):
    rng = np.random.default_rng(1)
    pred = torch.from_numpy(rng.standard_normal((4, 240, 160)).astype(np.float32)).to(cuda_device)
    target = torch.from_numpy(synthesize_batch(rng, 4, 480, 320)["region"]).to(cuda_device)
    want = ohem_mse(pred.cpu(), target.cpu())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ohem_mse(pred, target)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0)
