"""CRNN training of the PyTorch port vs the JAX package (CPU).

The losses, BatchNorm in training mode, teacher forcing, the TPS
rectifier in training mode, one train step (loss, gradients, an Adam
update, the batch statistics) and the eval step, for the CTC head, the
attention head and attention with TPS, from the JAX init carried across
with ``state_dict_from_variables``; the optimizers against optax; remat,
``grad_accum`` and the training init in the port alone.

The train step is compared in float64 on both sides (JAX with
``jax_enable_x64``, the port's model ``.double()``); the eval step, which
reads the running statistics, in float32.  In float32 the JAX
package's own gradients on this tiny ResNet are off by up to ~14% from its
float64 ones (flax's BatchNorm computes the variance as E[x^2] - E[x]^2,
which cancels where a channel's mean is large against its spread), so a
float32 comparison would measure that rounding, not the port.  The TPS
rectifier computes its sampling grid in float32 on both sides, in
different orders (~1e-5 px apart); this tiny network at init moves its
gradients by several percent for such a change of its input, so the TPS
case feeds the port's ResNet the JAX rectifier's output (a straight-through
forward hook); the gradient of the rectifier's parameters still comes from
the port's own grid and sampler, and is compared with the rest.  The
rectifier alone is held to the JAX one in its own test, at the training
init and off it.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
import flax.linen as fnn

from lightly_ocr_tpu.config import Config as JConfig
from lightly_ocr_tpu.models.attention import Attention as JAttention
from lightly_ocr_tpu.models.crnn import CRNNet as JCRNNet
from lightly_ocr_tpu.models.tps import TPS_STN as JTPS
from lightly_ocr_tpu.ops.ctc import cross_entropy_ignore_index as jce
from lightly_ocr_tpu.ops.ctc import ctc_forward_logprob as jctc_forward
from lightly_ocr_tpu.ops.ctc import ctc_loss as jctc_loss
from lightly_ocr_tpu.text.converters import build_converter as jbuild_converter
from lightly_ocr_tpu.train.train_step import TrainState as JTrainState
from lightly_ocr_tpu.train.train_step import loss_fn as jloss_fn
from lightly_ocr_tpu.train.train_step import make_eval_step as jmake_eval_step
from lightly_ocr_tpu.train.train_step import make_optimizer as jmake_optimizer
from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.models.attention import Attention
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.layers import BatchNorm2d, frozen_batch_stats, init_train_params
from lightly_ocr_tpu_torch.models.lstm import BidirectionalLSTM
from lightly_ocr_tpu_torch.models.tps import TPS_STN, fiducial_bias_init
from lightly_ocr_tpu_torch.ops.ctc import cross_entropy_ignore_index, ctc_forward_logprob, ctc_loss
from lightly_ocr_tpu_torch.train.train_step import (
    TrainState,
    clip_by_global_norm_,
    init_train_state,
    loss_fn,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from lightly_ocr_tpu_torch.parallel.launch import spawn
from lightly_ocr_tpu_torch.weights import state_dict_from_variables
from torch_dp_workers import assert_step_equal, run_cases

# the tiny config of tests/test_training.py, Adam for the update check
_SMALL = dict(sequence="biLSTM", output_channel=64, hidden_size=32, height=32, width=64,
              batch_max_len=8, character="abcdefghij", batch_size=4, num_fiducial=8,
              adam=True, lr=1e-3)
CASES = {"CTC": dict(prediction="CTC", transform="None"),
         "Attention": dict(prediction="Attention", transform="None"),
         "TPS": dict(prediction="Attention", transform="TPS")}
LABELS = ["abc", "de", "fghij", "a"]


def host_batch(cfg, seed=0, dtype=np.float64):
    """images [4, 32, 64, 1] from a numpy seed and the labels, encoded by
    the JAX package's converter (the port's is held to it in
    ``tests/test_torch_data.py``)."""
    conv = jbuild_converter(cfg.prediction, cfg.character)
    batch = {"images": np.random.default_rng(seed).standard_normal(
        (len(LABELS), cfg.height, cfg.width, 1)).astype(dtype)}
    if cfg.prediction == "CTC":
        batch["labels"], batch["lengths"] = conv.encode_padded(LABELS, cfg.batch_max_len)
    else:
        batch["text"], batch["lengths"] = conv.encode(LABELS, cfg.batch_max_len)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) if k == "images" else torch.from_numpy(v).long()
            for k, v in batch.items()}


def to_state_dict(params, stats=None):
    tree = {"params": jax.tree.map(np.asarray, params)}
    if stats is not None:
        tree["batch_stats"] = jax.tree.map(np.asarray, stats)
    return state_dict_from_variables(tree, np.float64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist several
    test processes share the machine's cores, and torch's default of a
    thread a core oversubscribes them many times over (this module's tiny
    steps then take minutes, not seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """The JAX package's train-step pieces in float64 for one head: its
    init, loss, gradients, the batch statistics after the step, the
    parameters after one Adam update, and its eval step; one compile of
    each; the eval step in float32."""
    name = request.param
    kw = {**_SMALL, **CASES[name]}
    jcfg, cfg = JConfig(**kw), Config(**kw)
    batch = host_batch(jcfg)
    model = JCRNNet(jcfg)
    text0 = jnp.zeros((2, jcfg.num_steps), jnp.int32)
    v = jax.jit(lambda r: model.init(r, jnp.zeros((2, 32, 64, 1)), text0, True))(jax.random.key(0))
    v = jax.tree.map(np.asarray, v)
    out = {"name": name, "cfg": cfg, "batch": batch,
           "eval": jax.tree.map(np.asarray, jmake_eval_step(model, jcfg)(
               JTrainState(v["params"], v["batch_stats"], None, 0),
               {k: jnp.asarray(a, jnp.float32 if k == "images" else jnp.int32)
                for k, a in batch.items()}))}
    with x64():
        model = JCRNNet(jcfg, dtype=jnp.float64)
        params, stats = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v[k])
                         for k in ("params", "batch_stats"))
        jb = {k: jnp.asarray(a) for k, a in batch.items()}
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, s, b: jloss_fn(model, jcfg, p, s, b, True), has_aux=True))
        (loss, (new_stats, _)), grads = grad_fn(params, stats, jb)
        opt = jmake_optimizer(jcfg)
        updates, _ = jax.jit(opt.update)(grads, opt.init(params), params)
        out.update(loss=float(loss), init=to_state_dict(params, stats), grads=to_state_dict(grads),
                   after=to_state_dict(optax.apply_updates(params, updates), new_stats))
        if name == "TPS":
            tps = JTPS(F=jcfg.num_fiducial, out_h=jcfg.height, out_w=jcfg.width, dtype=jnp.float64)
            rect, _ = jax.jit(lambda p, s, x: tps.apply({"params": p, "batch_stats": s}, x, True,
                                                        mutable=["batch_stats"]))(
                params["Transformation"], stats["Transformation"], jb["images"])
            out["rectified"] = torch.from_numpy(np.array(rect)).permute(0, 3, 1, 2)
    return out


def port_model(case) -> CRNNet:
    net = CRNNet(case["cfg"])
    net.load_state_dict(case["init"], strict=True)
    net.double().train()
    if case["name"] == "TPS":  # the JAX rectifier's output (module docstring); the
        # gradient still flows through the port's own rectifier
        net.Transformation.register_forward_hook(lambda m, i, o: o + (case["rectified"] - o).detach())
    return net


def test_train_step_loss_and_gradients_match_jax(case):
    """Loss to rtol 1e-5; every gradient to rtol 1e-3, atol 1e-5 (the JAX
    package's remat bound, tests/test_training.py), the TPS rectifier's
    included: at the training init only its ``localization_fc2`` has a
    gradient, through the port's own sampler and grid."""
    net = port_model(case)
    loss, _ = loss_fn(net, case["cfg"], torch_batch(case["batch"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), case["loss"], rtol=1e-5)
    for n, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), case["grads"][n].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=n)


def test_float32_loss_matches_jax(case):
    """The port's float32 model (TPS sampling its own grid) gives the JAX
    package's float64 loss to rtol 1e-5."""
    net = CRNNet(case["cfg"])
    net.load_state_dict({k: v.float() for k, v in case["init"].items()}, strict=True)
    b = torch_batch(case["batch"])
    b["images"] = b["images"].float()
    loss, _ = loss_fn(net.train(), case["cfg"], b)
    np.testing.assert_allclose(loss.item(), case["loss"], rtol=1e-5)


def test_adam_step_matches_jax(case):
    """Weights and batch statistics after one Adam step, every tensor
    (the TPS fiducial head's included): rtol 2e-5, atol 2e-6."""
    net = port_model(case)
    state = TrainState(net, make_optimizer(case["cfg"], net.parameters()))
    state, metrics = make_train_step(net, case["cfg"])(state, torch_batch(case["batch"]))
    assert state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(), case["loss"], rtol=1e-5)
    got = net.state_dict()
    assert got.keys() == case["after"].keys()
    for k, ref in case["after"].items():
        np.testing.assert_allclose(got[k].numpy(), ref.numpy(), rtol=2e-5, atol=2e-6, err_msg=k)


def test_two_rank_step_matches_jax(case):
    """The data-parallel step over two gloo ranks (spawned, one thread
    each), each on its half of the batch, equals the JAX package's
    single-device float64 step on the whole batch (which
    ``tests/test_multichip.py`` holds equal to its mesh step): loss 1e-10,
    each gradient and each tensor after the update 1e-8 relative L2 (the
    TPS rectifier's 1e-3, as above; after the update, 1e-6 elsewhere in
    the TPS case: Adam divides each gradient by its own size, which
    magnifies the rectifier's round-off where a gradient is near eps).  The
    halves hold different numbers of target tokens (``abc de`` against
    ``fghij a``), so a per-shard normaliser, BatchNorm or mean fails it."""
    lengths = case["batch"]["lengths"]
    assert lengths[:2].sum() != lengths[2:].sum()
    payload = {"cfg": case["cfg"], "init": case["init"], "batch": torch_batch(case["batch"])}
    if case["name"] == "TPS":
        payload["rectified"] = case["rectified"]
    got = spawn(run_cases, ({case["name"]: ("crnn", payload)},), ["cpu", "cpu"])[case["name"]]

    def tol(name):
        return 1e-3 if name.startswith("Transformation.") else 1e-8

    assert_step_equal(got, case["loss"], case["grads"], case["after"], case["init"], tol=tol,
                      after_tol=(lambda n: max(tol(n), 1e-6)) if case["name"] == "TPS" else None)


def test_eval_step_matches_jax(case):
    """Eval mode (greedy decode for attention; float32): pred_idx equal,
    confidence to 1e-5, loss to rtol 1e-5."""
    net = CRNNet(case["cfg"])
    net.load_state_dict({k: v.float() for k, v in case["init"].items()}, strict=True)
    b = torch_batch(case["batch"])
    b["images"] = b["images"].float()
    out = make_eval_step(net.train(), case["cfg"])(TrainState(net, None), b)
    assert net.training  # the mode is put back
    ref = case["eval"]
    np.testing.assert_array_equal(out["pred_idx"].numpy(), ref["pred_idx"])
    np.testing.assert_allclose(out["confidence"].numpy(), ref["confidence"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), rtol=1e-5)


@pytest.mark.parametrize("fc2", ["init", "moved"])
def test_tps_training_sampler_matches_jax(fc2):
    """The rectifier in training mode (float32 grid on both sides), at the
    training init (``localization_fc2`` weight 0, bias the fiducials: the
    only parameters with a gradient there) and with the fiducial head moved
    off it (the warp no longer the sheared init one): the image within 1e-4
    of the largest value (the grids differ by ~1e-5 px), and the gradient of
    every localization-network parameter and of the input within 1e-3 of
    each tensor's largest value, for a seeded cotangent; a gradient that is
    0 in JAX is 0 in the port."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 32, 64, 1)).astype(np.float32)
    cot = rng.standard_normal((4, 32, 64, 1)).astype(np.float32)
    jm = JTPS(F=8, out_h=32, out_w=64)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(1), jnp.zeros((2, 32, 64, 1)), True))
    fc2_kernel = v["params"]["LocalizationNetwork"]["localization_fc2"]["kernel"]
    assert not fc2_kernel.any()  # the fiducial init
    if fc2 == "moved":
        v["params"]["LocalizationNetwork"]["localization_fc2"]["kernel"] = (
            0.01 * rng.standard_normal(fc2_kernel.shape)).astype(np.float32)

    def f(p, x):
        y, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, x, True, mutable=["batch_stats"])
        return jnp.sum(y * cot), y

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        v["params"], jnp.asarray(x))
    m = TPS_STN(8, 32, 64, 1)
    m.load_state_dict(state_dict_from_variables(v), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = m.train()(xt)
    (y * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()

    def close(a, b, tol, msg=""):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), msg

    close(y.detach().permute(0, 2, 3, 1).numpy(), ref, 1e-4)
    close(xt.grad.permute(0, 2, 3, 1).numpy(), gx, 1e-3)
    jg = state_dict_from_variables({"params": jax.tree.map(np.asarray, gp)})
    grads = {n: p.grad.numpy() for n, p in m.named_parameters()}
    assert grads.keys() == jg.keys()
    fc2_names = {"LocalizationNetwork.localization_fc2.weight", "LocalizationNetwork.localization_fc2.bias"}
    for n, g in grads.items():
        ref_g = jg[n].numpy()
        assert (fc2 == "moved" or n in fc2_names) == bool(ref_g.any()), n
        close(g, ref_g, 1e-3, n)
    m.load_state_dict(state_dict_from_variables(v), strict=True)  # the statistics before the step
    with torch.no_grad():  # eval mode (running statistics)
        close(m.eval()(xt).permute(0, 2, 3, 1).numpy(), jm.apply(v, jnp.asarray(x), False), 1e-4)


# -- losses --------------------------------------------------------------

def test_ctc_loss_matches_jax():
    """Loss to rtol 1e-5 and its gradient with respect to the logits (through
    log_softmax, as the train step takes it) to atol 1e-5, float32; with an
    empty label, a repeated letter, and a label no alignment fits (zeroed by
    zero_infinity); per-sample log-likelihoods to rtol 1e-5."""
    rng = np.random.default_rng(5)
    B, T, C, L = 5, 12, 7, 6
    logits = rng.standard_normal((B, T, C)).astype(np.float32) * 2
    labels = rng.integers(1, C, (B, L)).astype(np.int32)
    labels[1, :3] = [2, 2, 3]
    lengths = np.asarray([4, 3, 0, 6, 6], np.int32)
    lengths_in = np.full((B,), T, np.int32)
    lengths_in[4] = 5  # 6 labels cannot fit 5 frames: infinite, zeroed

    def jfn(z):
        return jctc_loss(jax.nn.log_softmax(z, axis=2), jnp.asarray(labels),
                         jnp.asarray(lengths_in), jnp.asarray(lengths))

    jl, jg = jax.value_and_grad(jfn)(jnp.asarray(logits, jnp.float32))
    z = torch.from_numpy(logits).requires_grad_()
    args = (torch.from_numpy(labels).long(), torch.from_numpy(lengths_in).long(),
            torch.from_numpy(lengths).long())
    loss = ctc_loss(torch.log_softmax(z, 2), *args)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(jg), atol=1e-5)
    lp = ctc_forward_logprob(torch.log_softmax(z.detach(), 2), *args).numpy()
    jlp = np.asarray(jctc_forward(jax.nn.log_softmax(jnp.asarray(logits), 2), jnp.asarray(labels),
                                  jnp.asarray(lengths_in), jnp.asarray(lengths)))
    np.testing.assert_allclose(lp[:4], jlp[:4], rtol=1e-5)
    assert lp[4] == -np.inf and jlp[4] < -1e29
    with pytest.raises(ValueError):
        ctc_loss(torch.log_softmax(z.detach(), 2), *args, reduction="max")


def test_cross_entropy_ignore_index_matches_jax():
    """Mean over the targets not ignored (rtol 1e-6, gradient atol 1e-6); an
    all-ignored batch gives 0 with a zero, finite gradient."""
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 9, 12)).astype(np.float32)
    targets = rng.integers(0, 12, (3, 9)).astype(np.int32)
    targets[:, -3:] = 0
    jl, jg = jax.value_and_grad(lambda z: jce(z, jnp.asarray(targets)))(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    loss = cross_entropy_ignore_index(z, torch.from_numpy(targets))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(jg), atol=1e-6)
    z.grad = None
    empty = cross_entropy_ignore_index(z, torch.zeros(3, 9, dtype=torch.long))
    empty.backward()
    assert empty.item() == 0.0 and torch.isfinite(z.grad).all() and not z.grad.any()


# -- modules in training mode --------------------------------------------

def test_batchnorm_training_matches_flax():
    """Training-mode BatchNorm vs flax's (momentum 0.9, eps 1e-5): output to
    atol 1e-5; running statistics after the step with the biased variance
    to rtol 1e-5; frozen statistics stay; eval mode reads them."""
    rng = np.random.default_rng(7)
    x = (0.5 + rng.standard_normal((4, 6, 5, 3)) * rng.uniform(0.5, 2, 3)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.key(0), jnp.asarray(x))
    v = {"params": {"scale": np.linspace(0.5, 1.5, 3).astype(np.float32),
                    "bias": np.asarray([0.1, -0.2, 0.3], np.float32)},
         "batch_stats": {"mean": np.asarray([0.2, 0.0, -0.1], np.float32),
                         "var": np.asarray([1.0, 2.0, 0.5], np.float32)}}
    ref, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    m = BatchNorm2d(3)
    m.load_state_dict({"weight": torch.from_numpy(v["params"]["scale"]),
                       "bias": torch.from_numpy(v["params"]["bias"]),
                       "running_mean": torch.from_numpy(v["batch_stats"]["mean"]),
                       "running_var": torch.from_numpy(v["batch_stats"]["var"])}, strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with frozen_batch_stats(m):
        m.train()(xt)
    np.testing.assert_array_equal(m.running_var.numpy(), v["batch_stats"]["var"])
    got = m(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), rtol=1e-5)
    biased = x.reshape(-1, 3).var(0)
    np.testing.assert_allclose(m.running_var.numpy(), 0.9 * v["batch_stats"]["var"] + 0.1 * biased, rtol=1e-5)
    assert "num_batches_tracked" not in m.state_dict()
    ev = fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        {"params": v["params"], "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])}, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(m.eval()(xt).permute(0, 2, 3, 1).numpy(), np.asarray(ev), atol=1e-5)


def test_teacher_forced_attention_matches_jax():
    """Training mode feeds one_hot(text[:, s]) each step: logits to atol
    1e-5 (float32); ``lm`` is refused there as in JAX."""
    rng = np.random.default_rng(8)
    B, T, n_in, H, C, S = 3, 11, 16, 24, 9, 6
    feats = rng.standard_normal((B, T, n_in)).astype(np.float32)
    text = rng.integers(0, C, (B, S + 1)).astype(np.int32)
    jm = JAttention(hidden=H, num_classes=C, num_steps=S)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(2), jnp.asarray(feats), jnp.asarray(text), True))
    ref = np.asarray(jm.apply(v, jnp.asarray(feats), jnp.asarray(text), True))
    m = Attention(n_in, H, C, S)
    m.load_state_dict(state_dict_from_variables(v), strict=True)
    got = m.train()(torch.from_numpy(feats), text=torch.from_numpy(text).long())
    assert got.shape == ref.shape == (B, S, C)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5)
    with pytest.raises(ValueError, match="inference-only"):
        m(torch.from_numpy(feats), lm=torch.zeros(C, C), text=torch.from_numpy(text).long())
    with torch.no_grad():  # without text, the greedy decode, in either mode
        greedy = m(torch.from_numpy(feats))
        torch.testing.assert_close(m.eval()(torch.from_numpy(feats)), greedy)


def test_quant_training_is_refused():
    cfg = Config(**{**_SMALL, **CASES["CTC"]})
    net = CRNNet(cfg, quant=True).train()
    with pytest.raises(ValueError, match="inference-only"):
        net(torch.zeros(2, 32, 64, 1))
    with torch.no_grad():
        assert net(torch.zeros(2, 32, 64, 1)).shape[0] == 2
        assert net.eval()(torch.zeros(2, 32, 64, 1)).shape[0] == 2
    with pytest.raises(ValueError, match="inference-only"):
        init_train_state(cfg.replace(quant_int8=True), 0, "cpu")


def test_init_train_state_defaults_to_the_card():
    """Without ``device`` the state is made on ``cuda``: where there is no
    card that raises, and nothing falls back to the CPU."""
    import inspect

    assert inspect.signature(init_train_state).parameters["device"].default == "cuda"
    cfg = Config(**{**_SMALL, **CASES["CTC"]})
    if torch.cuda.is_available():
        net, _ = init_train_state(cfg, 0)
        assert next(net.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_train_state(cfg, 0)


# -- the optimizers --------------------------------------------------------

@pytest.mark.parametrize("adam", [True, False], ids=["adam", "adadelta"])
def test_optimizer_matches_optax(adam):
    """Five steps of the clip (optax's clip_by_global_norm at 5; two of the
    steps' gradients are above it) and Adam or Adadelta: parameters to
    rtol 1e-6, atol 1e-8 of optax's, float32."""
    cfg = Config(adam=adam, lr=1e-3 if adam else 0.5)
    rng = np.random.default_rng(9)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}
             for scale in (0.3, 4.0, 0.1, 2.5, 0.5)]
    opt = jmake_optimizer(JConfig(adam=adam, lr=cfg.lr))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = make_optimizer(cfg, list(tp.values()))
    norms = []
    for g in grads:
        upd, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norms.append(clip_by_global_norm_([p.grad for p in tp.values()], cfg.grad_clip).item())
        topt.step()
    assert sum(n > cfg.grad_clip for n in norms) == 2
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-8)


# -- the port alone ----------------------------------------------------------

def _port_pair(cfg, seed=0):
    nets = []
    for _ in range(2):
        net, state = init_train_state(cfg, seed, "cpu")
        nets.append((net, state))
    return nets


@pytest.mark.parametrize("head", ["CTC", "TPS"])
def test_remat_equals_plain(head):
    """train_remat recomputes the forward in the backward: the loss, the
    parameters after the step and the BatchNorm running statistics equal
    the plain step's (the recomputation does not count its batch again)."""
    cfg = Config(**{**_SMALL, **CASES[head]})
    (n0, s0), (n1, s1) = _port_pair(cfg)
    b = torch_batch(host_batch(cfg, dtype=np.float32))
    _, m0 = make_train_step(n0, cfg)(s0, b)
    _, m1 = make_train_step(n1, cfg.replace(train_remat=True))(s1, b)
    assert m0["loss"].item() == m1["loss"].item()
    sd0, sd1 = n0.state_dict(), n1.state_dict()
    for k in sd0:
        torch.testing.assert_close(sd1[k], sd0[k], rtol=1e-6, atol=1e-7, msg=k)


def test_grad_accum_equals_plain():
    """grad_accum=2 over two equal micro-batches: the loss and the
    parameters after the update equal the plain step's; the running
    statistics moved once for each micro-batch."""
    cfg = Config(**{**_SMALL, **CASES["Attention"]})
    (n0, s0), (n1, s1) = _port_pair(cfg)
    b = torch_batch(host_batch(cfg, dtype=np.float32))
    _, m0 = make_train_step(n0, cfg)(s0, b)
    twice = {k: torch.stack([v, v]) for k, v in b.items()}
    _, m1 = make_train_step(n1, cfg.replace(grad_accum=2))(s1, twice)
    torch.testing.assert_close(m1["loss"], m0["loss"], rtol=1e-6, atol=0)
    sd0, sd1 = n0.state_dict(), n1.state_dict()
    (n2, _), _ = _port_pair(cfg)
    with torch.no_grad():  # the statistics of two plain forwards
        n2(b["images"], b["text"][:, :-1])
        n2(b["images"], b["text"][:, :-1])
    sd2 = n2.state_dict()
    for k in sd0:
        ref = sd2[k] if k.endswith(("running_mean", "running_var")) else sd0[k]
        torch.testing.assert_close(sd1[k], ref, rtol=1e-6, atol=1e-7, msg=k)


def test_train_init_is_flax_like_and_healthy():
    """``init_train_params``: lecun-normal weights truncated at 2 std (the
    std within 10% of sqrt(1/fan_in) for tensors of 1,000+ values), zero
    biases, BatchNorm (1, 0, 0, 1), symmetric LSTM tensors within
    1/sqrt(H), the TPS head at its fiducial init; and the self-initialised
    BiLSTM's output depends on its input (tests/test_training.py's
    TestSelfInitHealth)."""
    cfg = Config(**{**_SMALL, **CASES["TPS"]})
    net = init_train_params(CRNNet(cfg), torch.Generator().manual_seed(0))
    for name, m in net.named_modules():
        if name.endswith("localization_fc2"):
            assert not m.weight.any()
            np.testing.assert_array_equal(m.bias.detach().numpy(), fiducial_bias_init(cfg.num_fiducial))
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            w = m.weight.detach()
            std = (1.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
            assert w.abs().max() <= 2 * std * (1 + 1e-6), name
            if w.numel() >= 1000:  # a normal truncated at 2 std keeps 0.8796 of its std
                assert abs(w.std().item() / (std * 0.87962566103423978) - 1) < 0.1, name
            assert m.bias is None or not m.bias.any(), name
        elif isinstance(m, BatchNorm2d):
            assert (m.weight == 1).all() and not m.bias.any() and not m.running_mean.any()
            assert (m.running_var == 1).all()
        elif isinstance(m, (torch.nn.LSTM, torch.nn.LSTMCell)):
            k = 1.0 / m.hidden_size ** 0.5
            for p in m.parameters(recurse=False):
                a = p.detach().numpy()
                assert a.min() < -0.2 * k and a.max() > 0.2 * k and abs(a.mean()) < 0.2 * k, name
                assert np.abs(a).max() <= k + 1e-7, name
    lstm = init_train_params(BidirectionalLSTM(64, 32, 32), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.abs(np.random.default_rng(4420).standard_normal((8, 26, 64))).astype(np.float32))
    with torch.no_grad():
        y = lstm(x).numpy()
    assert y.mean(axis=(1, 2)).std() > 0.01 * y.std()
