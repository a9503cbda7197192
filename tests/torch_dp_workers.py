"""Process targets of the data-parallel tests, and their comparison.

The targets run in processes that ``lightly_ocr_tpu_torch.parallel.launch.
spawn`` starts (``test_torch_train.py``, ``test_torch_craft.py``,
``test_torch_parallel.py``), so this module imports nothing of JAX: a
spawned process imports it by name, with the port alone.  Every target
takes a payload of plain tensors and returns rank 0's results.
"""
import contextlib

import numpy as np
import torch

from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.parallel.collectives import group_rank, group_size
from lightly_ocr_tpu_torch.train import craft
from lightly_ocr_tpu_torch.train.train_step import TrainState, make_optimizer, make_train_step


def _rows(batch: dict, group) -> dict:
    """This process's contiguous share of a global batch."""
    r, n = group_rank(group), group_size(group)
    per = next(iter(batch.values())).shape[0] // n
    return {k: v[r * per:(r + 1) * per] for k, v in batch.items()}


def _result(net, metrics) -> dict:
    return {"loss": metrics["loss"].item(), "grad_norm": metrics["grad_norm"].item(),
            "state": {k: v.detach().clone() for k, v in net.state_dict().items()},
            "grads": {n: p.grad.detach().clone() for n, p in net.named_parameters()
                      if p.grad is not None}}


def crnn_step(case: dict, device, group=None) -> dict:
    """One train step of a float64 ``CRNNet`` from ``case["init"]`` on this
    process's rows of ``case["batch"]``.  ``case["rectified"]``, if given,
    is fed to the ResNet in place of the rectifier's output (straight
    through, as ``test_torch_train.py`` does)."""
    cfg = case["cfg"]
    net = CRNNet(cfg)
    net.load_state_dict(case["init"], strict=True)
    net.double().train().to(device)
    if "rectified" in case:
        rect = _rows({"x": case["rectified"]}, group)["x"].to(device)
        net.Transformation.register_forward_hook(lambda m, i, o: o + (rect - o).detach())
    state = TrainState(net, make_optimizer(cfg, net.parameters()))
    batch = {k: v.to(device) for k, v in _rows(case["batch"], group).items()}
    state, metrics = make_train_step(net, cfg, group)(state, batch)
    return _result(net, metrics)


def craft_step(case: dict, device, group=None) -> dict:
    """One CRAFT train step of a float64 ``VGG_UNet`` from ``case["init"]``
    with ``case["freeze"]`` on this process's rows of ``case["batch"]``."""
    net = VGG_UNet()
    net.load_state_dict(case["init"], strict=True)
    net.double().train().to(device)
    state = TrainState(net, craft.make_craft_optimizer(net.parameters()))
    batch = {k: v.to(device) for k, v in _rows(case["batch"], group).items()}
    step = craft.make_craft_train_step(net, freeze=case["freeze"], group=group)
    state, metrics = step(state, batch)
    return _result(net, metrics)


@contextlib.contextmanager
def one_torch_thread():
    """torch on one CPU thread inside the block, the caller's count after
    it (these targets also run in the test's own process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def run_cases(cases: dict, device, group=None) -> dict:
    """Every case of ``cases`` (``{name: (target name, payload)}``) in turn."""
    targets = {"crnn": crnn_step, "craft": craft_step}
    with one_torch_thread():
        out = {name: targets[kind](payload, device, group) for name, (kind, payload) in cases.items()}
    return out if group_rank(group) == 0 else None


def craft_training(kw: dict, device, group=None) -> list:
    """``train_craft(**kw)`` on this process; rank 0 returns the losses."""
    with one_torch_thread():
        _, _, losses = craft.train_craft(**kw, device=device, group=group)
    return losses


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_step_equal(got: dict, loss: float, grads: dict, after: dict, init: dict,
                      frozen=(), tol=lambda name: 1e-8, after_tol=None, clip: float = 5.0) -> None:
    """A data-parallel step's results (:func:`_result`) against the JAX
    package's single-device float64 step: its ``loss`` (1e-10 relative),
    raw gradients ``grads`` (``tol(name)`` relative L2, and their global
    norm to the largest of those), and the state ``after`` its update
    (``after_tol(name)``, default ``tol``).  The step leaves the clipped
    gradients in ``.grad`` (clipped by the norm of the trainable ones);
    ``frozen`` names have zero gradients and keep their ``init`` values.  Gradients that are zero in exact arithmetic
    (conv biases before a BatchNorm: round-off on each side) are held to
    zero, and left out of the state comparison (Adam's first step moves
    such a tensor by ``lr * g / (|g| + eps)`` of its round-off ``g``)."""
    after_tol = after_tol or tol
    norm = float(np.sqrt(sum(float((g.numpy() ** 2).sum()) for g in grads.values())))
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-10)
    np.testing.assert_allclose(got["grad_norm"], norm, rtol=max(map(tol, grads)))
    zero = {n for n, g in grads.items() if np.linalg.norm(g.numpy()) < 1e-12 * norm}
    # the step clipped by its own norm of the gradients it keeps (the frozen ones are zeroed
    # first; its reported norm holds them): that norm, from the reported one
    kept = np.sqrt(got["grad_norm"] ** 2 - sum(float((grads[n].numpy() ** 2).sum()) for n in frozen))
    scale = min(1.0, clip / kept)
    for n, g in grads.items():
        if n in frozen:
            assert not got["grads"][n].any(), n
        elif n in zero:
            assert got["grads"][n].norm() < 1e-12 * norm, n
        else:
            assert rel_l2(got["grads"][n] / scale, g) < tol(n), n
    assert got["state"].keys() == after.keys()
    for k, want in after.items():
        if k not in zero:
            assert rel_l2(got["state"][k], want) < after_tol(k), k
    for k in set(frozen) - zero:
        assert torch.equal(got["state"][k], init[k]), k
