"""Process targets of the parallel tests, and their comparison.

The targets run in processes that ``lightly_ocr_tpu_torch.parallel.launch.
spawn`` starts (``test_torch_train.py``, ``test_torch_craft.py``,
``test_torch_parallel.py``, ``test_torch_model_axis.py``), so this module
imports nothing of JAX: a spawned process imports it by name, with the port
alone.  Every target takes a payload of plain tensors and returns rank 0's
results.  ``group`` is a process group (a data axis) or a ``MeshGroups``
(a mesh with a model axis): the steps take this process's rows by its data
index and shard the model over its model group, and the results are the
full tensors.
"""
import contextlib

import numpy as np
import torch

from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.parallel.collectives import gather_along
from lightly_ocr_tpu_torch.parallel.mesh import mesh_groups, param_sharding_rules
from lightly_ocr_tpu_torch.parallel.tensor import full_state_dict, model_shards, shard_module
from lightly_ocr_tpu_torch.train import craft
from lightly_ocr_tpu_torch.train.train_step import TrainState, make_optimizer, make_train_step


def _rows(batch: dict, group) -> dict:
    """This process's contiguous share of a global batch (by data index)."""
    g = mesh_groups(group)
    per = next(iter(batch.values())).shape[0] // g.data_size
    return {k: v[g.data_index * per:(g.data_index + 1) * per] for k, v in batch.items()}


def _shard(net, full: dict, group):
    """Shard ``net`` over ``group``'s model axis and hold each rank's
    tensors to ``full``: a tensor the rules split is this rank's ``1/model``
    slice of dim 0, every other tensor the whole one."""
    g = mesh_groups(group)
    shard_module(net, g)
    rules = param_sharding_rules(full, g)
    assert model_shards(net) == {k: 0 for k, d in rules.items() if d == 0}
    for k, v in net.state_dict().items():
        want = full[k].to(v.dtype)
        if rules[k] == 0:
            n = want.shape[0] // g.model_size
            want = want[g.model_index * n:(g.model_index + 1) * n]
        assert torch.equal(v.cpu(), want), k
    return net


@contextlib.contextmanager
def counted_all_reduces():
    """This process's ``dist.all_reduce`` calls inside the block, counted
    in the list it yields."""
    import torch.distributed as dist

    real, calls = dist.all_reduce, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    dist.all_reduce = counted
    try:
        yield calls
    finally:
        dist.all_reduce = real


def _result(net, metrics, calls: int = 0) -> dict:
    shards = model_shards(net)
    grads = {n: p.grad.detach() for n, p in net.named_parameters() if p.grad is not None}
    return {"loss": metrics["loss"].item(), "grad_norm": metrics["grad_norm"].item(),
            "state": {k: v.detach().clone() for k, v in full_state_dict(net).items()},
            "grads": {n: (gather_along(g, 0, net.mesh_groups) if n in shards else g).clone()
                      for n, g in grads.items()},
            "local_shapes": {k: tuple(v.shape) for k, v in net.state_dict().items()},
            "collectives": calls}


def crnn_step(case: dict, device, group=None) -> dict:
    """One train step of a float64 ``CRNNet`` from ``case["init"]`` on this
    process's rows of ``case["batch"]``.  ``case["rectified"]``, if given,
    is fed to the ResNet in place of the rectifier's output (straight
    through, as ``test_torch_train.py`` does)."""
    cfg = case["cfg"]
    net = CRNNet(cfg)
    net.load_state_dict(case["init"], strict=True)
    _shard(net.double().train().to(device), case["init"], group)
    if "rectified" in case:
        rect = _rows({"x": case["rectified"]}, group)["x"].to(device)
        net.Transformation.register_forward_hook(lambda m, i, o: o + (rect - o).detach())
    state = TrainState(net, make_optimizer(cfg, net.parameters()))
    batch = {k: v.to(device) for k, v in _rows(case["batch"], group).items()}
    step = make_train_step(net, cfg, group)
    with counted_all_reduces() as calls:
        state, metrics = step(state, batch)
    return _result(net, metrics, calls[0])


def craft_step(case: dict, device, group=None) -> dict:
    """One CRAFT train step of a float64 ``VGG_UNet`` from ``case["init"]``
    with ``case["freeze"]`` on this process's rows of ``case["batch"]``."""
    net = VGG_UNet()
    net.load_state_dict(case["init"], strict=True)
    _shard(net.double().train().to(device), case["init"], group)
    state = TrainState(net, craft.make_craft_optimizer(net.parameters()))
    batch = {k: v.to(device) for k, v in _rows(case["batch"], group).items()}
    step = craft.make_craft_train_step(net, freeze=case["freeze"], group=group)
    with counted_all_reduces() as calls:
        state, metrics = step(state, batch)
    return _result(net, metrics, calls[0])


def crnn_forward(case: dict, device, group=None) -> torch.Tensor:
    """The eval forward of a float32 ``CRNNet`` from ``case["init"]``,
    sharded over ``group``'s model axis, on ``case["images"]``."""
    net = CRNNet(case["cfg"])
    net.load_state_dict(case["init"], strict=True)
    _shard(net.eval().to(device), case["init"], group)
    with torch.no_grad():
        return net(case["images"].to(device)).cpu()


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
    targets = {"crnn": crnn_step, "craft": craft_step, "forward": crnn_forward}
    with one_torch_thread():
        out = {name: targets[kind](payload, device, group) for name, (kind, payload) in cases.items()}
    return out if mesh_groups(group).lead else None


def craft_training(kw: dict, device, group=None) -> list:
    """``train_craft(**kw)`` on this process; rank 0 returns the losses."""
    with one_torch_thread():
        _, _, losses = craft.train_craft(**kw, device=device, group=group)
    return losses


STEP_TOL = 1e-12
# A state tensor whose one-process gradient has an element below the
# optimizers' eps (1e-8): the first update, lr * g / (|g| + eps) for Adam,
# weighs that element like the others and carries its own relative
# round-off (1e-9 for an element of 5e-9 in the CRAFT case), not the
# tensor's.  Such a tensor is held to this.
TINY_GRAD_STATE_TOL = 1e-9


def assert_same_step(got: dict, want: dict, tol: float = STEP_TOL) -> None:
    """Loss, grad_norm, every gradient (clipped, gathered) and every tensor
    of the updated state within ``tol`` relative (L2 for tensors), a state
    tensor with a gradient element below the optimizers' eps within
    ``TINY_GRAD_STATE_TOL``.  Gradients that are zero in exact arithmetic
    (conv biases before a BatchNorm: round-off on each side) are held to
    zero on both sides, and their tensors left out of the state comparison
    (the optimizer moves them by their round-off), as
    :func:`assert_step_equal` does."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=tol)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=tol)
    norm = want["grad_norm"]
    zero = {k for k, g in want["grads"].items() if g.norm() < 1e-12 * norm}
    assert got["grads"].keys() == want["grads"].keys()
    for k, g in want["grads"].items():
        if k in zero:
            assert got["grads"][k].norm() < 1e-12 * norm, k
        else:
            assert rel_l2(got["grads"][k], g) <= tol, k
    assert got["state"].keys() == want["state"].keys()
    for k, v in want["state"].items():
        assert got["state"][k].shape == v.shape, k
        g = want["grads"].get(k)
        tiny = g is not None and g.abs().min() < 1e-8
        if k not in zero:
            assert rel_l2(got["state"][k], v) <= (TINY_GRAD_STATE_TOL if tiny else tol), k


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
