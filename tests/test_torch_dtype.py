"""Training in a reduced compute dtype: the port's bfloat16 steps against the
JAX package's (CPU).

Both packages keep float32 parameters and compute in the model's ``dtype``
(flax's rule: every conv, Dense and LSTM casts its parameters to the
compute dtype before the product; BatchNorm reduces in float32 and rounds
once).  The port's ``init_craft_state(dtype=)``, ``init_crnn(dtype=)`` and
``init_train_state(model=CRNNet(cfg, dtype=))`` are held to the JAX
package's ``init_craft_state(dtype=)``, ``init_crnn`` and ``loss_fn`` of a
``CRNNet(cfg, dtype=)``, on the same weights and batches.

A bfloat16 step is reproducible block by block, not whole.  The port's
forward rounds as the JAX program is written (every op to its dtype); XLA
rounds where its float32 sums and fusions lead it.  A ReLU or a max pool
whose input such a one-ulp difference moves across its kink passes
another cotangent, and that difference grows with depth: the whole CRAFT
step at 64x64 b2 is 0.31 relative L2 from the JAX step's gradients while
every block alone is within 0.04, and the JAX step moves 0.22 from itself
under a one-ulp nudge of its float32 weights
(``scripts/torch_bf16_step_spread.py``).  So the whole step is held where
it is reproducible (CRAFT's loss, batch statistics and maps; the CRNN's
loss and its ``Prediction`` and ``SequenceModeling`` gradients), and the
gradients block by block: each CRAFT block (VGG slice, decoder block,
head) on the JAX step's own input and output cotangent, and the CRNN's
blocks (a ResNet block, the TPS's localization units and its sampling, a
decoder block, a BiLSTM) on the same seeded input and cotangent.

The JAX models are compiled once per model in module fixtures; torch runs
on one thread while this module runs.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as nn

from lightly_ocr_tpu.config import Config as JConfig
from lightly_ocr_tpu.models.crnn import CRNNet as JCRNNet
from lightly_ocr_tpu.models.crnn import init_crnn as jinit_crnn
from lightly_ocr_tpu.models.lstm import BidirectionalLSTM as JBidirectionalLSTM
from lightly_ocr_tpu.models.resnet import BasicBlock as JBasicBlock
from lightly_ocr_tpu.models.tps import TPS_STN as JTPS_STN
from lightly_ocr_tpu.models.vgg_unet import UpConv as JUpConv
from lightly_ocr_tpu.models.vgg_unet import VGG_UNet as JVGG_UNet
from lightly_ocr_tpu.text.converters import build_converter as jbuild_converter
from lightly_ocr_tpu.train import craft as jcraft
from lightly_ocr_tpu.train.train_step import loss_fn as jloss_fn
from lightly_ocr_tpu.utils.torch_import import import_torch_state_dict
from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.models.crnn import CRNNet, init_crnn
from lightly_ocr_tpu_torch.models.decode import decode_preds
from lightly_ocr_tpu_torch.models.layers import (
    LSTM,
    BatchNorm2d,
    Conv2d,
    Linear,
    cast_to,
    init_train_params,
    to_serving,
)
from lightly_ocr_tpu_torch.models.lstm import BidirectionalLSTM
from lightly_ocr_tpu_torch.models.resnet import BasicBlock
from lightly_ocr_tpu_torch.models.tps import TPS_STN
from lightly_ocr_tpu_torch.models.vgg_unet import UpConv, VGG_UNet
from lightly_ocr_tpu_torch.parallel.mesh import MeshGroups
from lightly_ocr_tpu_torch.train import craft
from lightly_ocr_tpu_torch.train.train_step import init_train_state, loss_fn
from lightly_ocr_tpu_torch.weights import state_dict_from_variables

BF16 = torch.bfloat16
HW = 64  # the CRAFT step: b2, 64x64
# the tiny config of tests/test_training.py at half its width: 9 frames, so
# the JAX package's scans (unrolled by 13) compile in half the time
SMALL = dict(sequence="biLSTM", output_channel=64, hidden_size=32, height=32, width=32,
             batch_max_len=8, character="abcdefghij", batch_size=4, num_fiducial=8)
CASES = {"TPS": dict(prediction="Attention", transform="TPS"),
         "CTC": dict(prediction="CTC", transform="None")}
LABELS = ["abc", "de", "fghi", "a"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs (several test processes
    share the machine's cores under pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_state_dict(tree) -> dict:
    return state_dict_from_variables(jax.tree.map(np.asarray, tree))


def rel_l2(a: dict, b: dict, prefix: str = "") -> float:
    """Relative L2 of the tensors of ``a`` against ``b`` under ``prefix``,
    all of them as one vector."""
    keys = sorted(k for k in b if k.startswith(prefix))
    assert keys, prefix
    x = np.concatenate([np.asarray(a[k], np.float64).ravel() for k in keys])
    y = np.concatenate([np.asarray(b[k], np.float64).ravel() for k in keys])
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def grads_of(model) -> dict:
    return {n: p.grad.detach().float().numpy() for n, p in model.named_parameters()}


# -- CRAFT ---------------------------------------------------------------------

# the blocks of the CRAFT step, each held alone on the JAX step's own input
# and output cotangent
BLOCKS = ("basenet.slice1", "basenet.slice2", "basenet.slice3", "basenet.slice4", "basenet.slice5",
          "upconv1", "upconv2", "upconv3", "upconv4", "conv_cls")
# the convs with no BatchNorm after them: each bias gradient is the sum of
# the conv's output cotangent, which XLA on the CPU sums in bfloat16
SUMMED = ("basenet.slice5.1", "basenet.slice5.2") + tuple(f"conv_cls.{i}" for i in (0, 2, 4, 6, 8))


def craft_reference(init: dict) -> dict:
    """The JAX package's CRAFT step at b2, 64x64 (``train_craft``'s loss,
    maps cast to float32) on ``init`` (the port's ``init_craft_state``'s
    weights) carried into the JAX ``init_craft_state(dtype=bfloat16)``'s
    variables by its importer: the loss, the maps, the gradients and the
    new batch statistics; and, tapped by ``flax.linen.intercept_methods``
    (a zero added to each input and output, so the step is unchanged), the
    input of each of BLOCKS and the cotangents of its input and output, and
    the output cotangent of each conv of SUMMED (NCHW)."""
    batch = jcraft.synthesize_batch(np.random.default_rng(11), 2, HW, HW)
    shapes = jax.eval_shape(lambda r: jcraft.init_craft_state(r, dtype=jnp.bfloat16, image_hw=(HW, HW))[1],
                            jax.random.key(0))
    v = import_torch_state_dict({"params": jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes.params),
                                 "batch_stats": jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                                             shapes.batch_stats)},
                                {k: t.numpy() for k, t in init.items()})
    model = JVGG_UNet(dtype=jnp.bfloat16)

    def apply(p, zin, zout, taps):
        def tap(next_fun, args, kwargs, ctx):
            name = ".".join(ctx.module.path)
            if ctx.method_name != "__call__" or name not in BLOCKS + SUMMED:
                return next_fun(*args, **kwargs)
            x = args[0] + zin[name] if name in BLOCKS else args[0]
            taps[name] = x
            y = next_fun(x, *args[1:], **kwargs)
            taps[name + ":out"] = y
            return y + zout[name]

        with nn.intercept_methods(tap):
            (maps, _), new = model.apply({"params": p, "batch_stats": v["batch_stats"]}, batch["images"], True,
                                         mutable=["batch_stats"])
        return maps.astype(jnp.float32), new["batch_stats"]

    taps = {}
    zero = dict.fromkeys(BLOCKS + SUMMED, 0.0)
    jax.eval_shape(lambda: apply(v["params"], zero, zero, taps))
    zin = {k: jnp.zeros(taps[k].shape, taps[k].dtype) for k in BLOCKS}
    zout = {k: jnp.zeros(taps[k + ":out"].shape, taps[k + ":out"].dtype) for k in BLOCKS + SUMMED}

    def loss_fn_(p, zin, zout):
        taps = {}
        maps, stats = apply(p, zin, zout, taps)
        loss = jcraft.ohem_mse(maps[..., 0], batch["region"]) + jcraft.ohem_mse(maps[..., 1], batch["affinity"])
        return loss, (stats, maps, {k: taps[k] for k in BLOCKS})

    (loss, (stats, maps, xs)), (grads, dxs, gs) = jax.jit(jax.value_and_grad(
        loss_fn_, argnums=(0, 1, 2), has_aux=True))(v["params"], zin, zout)
    return {"batch": batch, "init": init, "loss": float(loss), "maps": np.asarray(maps),
            "grads": to_state_dict({"params": grads}),
            "stats": to_state_dict({"params": v["params"], "batch_stats": stats}),
            "x": {k: nchw(a) for k, a in xs.items()}, "dx": {k: nchw(a) for k, a in dxs.items()},
            "g": {k: nchw(a) for k, a in gs.items()}}


def crnn_reference(case: str) -> dict:
    """The port's ``init_crnn(cfg, 0, bfloat16)`` weights carried into the
    JAX package's ``init_crnn(cfg, rng, bfloat16)`` variables by its
    importer; the JAX bfloat16 training loss and gradients on a b4 batch,
    and its eval-mode greedy logits."""
    kw = dict(SMALL, **CASES[case])
    cfg, jcfg = Config(**kw), JConfig(**kw)
    batch = host_batch(cfg)
    net = init_crnn(cfg, 0, BF16, "cpu")
    shapes = jax.eval_shape(lambda r: jinit_crnn(jcfg, r, jnp.bfloat16)[1], jax.random.key(0))
    v = import_torch_state_dict(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes),
                                {k: t.numpy() for k, t in net.state_dict().items()})
    jnet = JCRNNet(jcfg, dtype=jnp.bfloat16)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, s, b: jloss_fn(jnet, jcfg, p, s, b, True), has_aux=True))(
        v["params"], v["batch_stats"], batch)
    logits = jax.jit(lambda v, x: jnet.apply(v, x, None, False))(v, batch["images"])
    return {"case": case, "cfg": cfg, "batch": batch, "net": net,
            "loss": float(loss), "loss_dtype": loss.dtype, "grads": to_state_dict({"params": grads}),
            "logits": torch.from_numpy(np.array(logits.astype(jnp.float32)))}


def nchw(a) -> torch.Tensor:
    """A JAX NHWC array as an NCHW torch tensor of its dtype (bfloat16 or
    float32)."""
    t = torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32))).permute(0, 3, 1, 2)
    return t.to(BF16) if a.dtype == jnp.bfloat16 else t


@pytest.fixture(scope="module")
def craft_init():
    """``init_craft_state(0, dtype=bfloat16)`` on the CPU: (model, state)."""
    return craft.init_craft_state(0, device="cpu", dtype=BF16)


@pytest.fixture(scope="module")
def refs(craft_init):
    """Every JAX reference of this module, traced and compiled in threads
    at once (XLA compiles without the GIL): ``{"craft": ..., case: ...}``."""
    init = {k: t.clone() for k, t in craft_init[0].state_dict().items()}
    with ThreadPoolExecutor(1 + len(CASES)) as pool:
        jobs = {"craft": pool.submit(craft_reference, init)}
        jobs.update({case: pool.submit(crnn_reference, case) for case in CASES})
        return {k: job.result() for k, job in jobs.items()}


@pytest.fixture(scope="module")
def craft_ref(refs):
    return refs["craft"]


def craft_port_step(ref, dtype):
    """The port's step on the same weights, a ``VGG_UNet(dtype=dtype)`` in
    ``train()`` (``init_craft_state``'s model): (model after the forward
    and backward, loss, maps)."""
    model = VGG_UNet(dtype=dtype).train()
    model.load_state_dict(ref["init"], strict=True)
    maps = []
    hook = model.conv_cls.register_forward_hook(lambda m, args, out: maps.append(out.detach()))
    loss = craft.craft_loss(model, craft.batch_to(ref["batch"], "cpu"))
    hook.remove()
    loss.backward()
    return model, loss.item(), maps[0].permute(0, 2, 3, 1).float().numpy()


@pytest.fixture(scope="module")
def craft_port(craft_ref):
    bf, loss, maps = craft_port_step(craft_ref, BF16)
    f32, _, _ = craft_port_step(craft_ref, torch.float32)
    return {"loss": loss, "maps": maps, "grads": grads_of(bf), "grads32": grads_of(f32),
            "stats": {k: t.numpy() for k, t in bf.state_dict().items() if "running" in k}}


def norm_of(grads: dict) -> float:
    return float(np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum() for g in grads.values())))


def test_craft_bf16_loss_matches_jax(craft_ref, craft_port):
    assert abs(craft_port["loss"] / craft_ref["loss"] - 1) <= 2e-3


def test_craft_bf16_batch_stats_match_jax(craft_ref, craft_port):
    """The running statistics after the step's forward (float32 on both
    sides), each tensor within 1e-2 relative L2."""
    for k, t in craft_port["stats"].items():
        assert t.dtype == np.float32
        assert rel_l2({k: t}, {k: craft_ref["stats"][k]}) <= 1e-2, k


def test_craft_bf16_maps_match_jax(craft_ref, craft_port):
    """The training forward's score maps (bfloat16, batch statistics) by the
    repo's bfloat16 score gate, max |diff| < 0.02."""
    assert craft_port["maps"].shape == craft_ref["maps"].shape
    assert float(np.abs(craft_port["maps"] - craft_ref["maps"]).max()) < 0.02


def test_craft_bf16_step_is_a_bf16_step(craft_ref, craft_port):
    """Against the float32 step (the port's, equal to the JAX package's in
    ``tests/test_torch_craft.py``) the port's bfloat16 gradients are as far
    as the JAX package's bfloat16 ones, within a factor of 2: a port that
    ran in float32 would be ~1e-5 away, one that rounded more would be
    further.  (The two whole bfloat16 steps are not held to each other:
    a ReLU or max-pool whose input the forward's round-off moves across
    its kink passes another cotangent, so the deep gradients part as far
    as the JAX step's own do under a one-ulp nudge of its weights,
    ``scripts/torch_bf16_step_spread.py``.  Each block is held alone
    below.)"""
    ref = rel_l2(craft_ref["grads"], craft_port["grads32"])
    got = rel_l2(craft_port["grads"], craft_port["grads32"])
    assert 0.5 * ref <= got <= 2 * ref


def test_craft_bf16_train_step_keeps_float32_state(craft_ref, craft_init):
    model, state = craft_init
    assert model.dtype == BF16 and model.training
    step = craft.make_craft_train_step(model)
    state, metrics = step(state, craft.batch_to(craft_ref["batch"], "cpu"))
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(t.dtype == torch.float32 for s in state.optimizer.state.values()
               for t in s.values() if torch.is_tensor(t) and t.ndim)
    maps, _ = model.eval()(torch.zeros(1, HW, HW, 3))
    assert maps.dtype == BF16


def craft_block_reference(ref: dict, block: str) -> dict:
    """The JAX step's gradients of ``block``'s parameters, except that each
    bias of SUMMED is the float64 sum of the JAX step's own cotangent of
    that conv (XLA on the CPU sums it in bfloat16: ``conv_cls.8.bias``
    -0.551 and -0.648 against the exact -0.394 and -0.491)."""
    out = {k: v.numpy().astype(np.float64) for k, v in ref["grads"].items() if k.startswith(block + ".")}
    for conv in SUMMED:
        if conv.startswith(block + "."):
            out[conv + ".bias"] = ref["g"][conv].double().sum((0, 2, 3)).numpy()
    return out


@pytest.fixture(scope="module")
def craft_blocks(craft_ref):
    """Each of BLOCKS of the port's ``VGG_UNet(dtype)`` in ``train()``, in
    bfloat16 and in float32, run alone on the JAX step's own input and
    output cotangent (bfloat16 values on both): ``{block: {"grads",
    "grads32", "dx", "stats"}}``."""
    nets = {}
    for dt in (BF16, torch.float32):
        nets[dt] = VGG_UNet(dtype=dt).train()
        nets[dt].load_state_dict(craft_ref["init"], strict=True)
    out = {}
    for block in BLOCKS:
        got = {}
        for dt, net in nets.items():
            mod = net.get_submodule(block)
            x = craft_ref["x"][block].to(dt, copy=True).requires_grad_(block != "basenet.slice1")
            mod(x).backward(craft_ref["g"][block].to(dt))
            got[dt] = ({f"{block}.{n}": p.grad.double().numpy() for n, p in mod.named_parameters()}, x.grad)
        out[block] = {"grads": got[BF16][0], "grads32": got[torch.float32][0], "dx": got[BF16][1],
                      "stats": {f"{block}.{n}": t.numpy() for n, t in
                                nets[BF16].get_submodule(block).state_dict().items() if "running" in n}}
    return out


@pytest.mark.parametrize("block", BLOCKS)
def test_craft_bf16_block_matches_the_jax_step(craft_ref, craft_blocks, block):
    """Each block of the CRAFT step alone, on the JAX bfloat16 step's own
    input and output cotangent: its gradients within 0.05 relative L2 and
    their norm within 1e-2, the cotangent it passes back within 0.05 and its
    new running statistics within 1e-2.  The bias gradient of a block's
    last conv (fc7, the head's last), the sum of the cotangent both sides
    were given, is within one bfloat16 rounding of its exact sum; the
    biases of the convs before a BatchNorm have a zero gradient, round-off
    on both sides: held to 1e-2 of the block's gradient norm."""
    got, want = craft_blocks[block]["grads"], craft_block_reference(craft_ref, block)
    assert got.keys() == want.keys()
    assert rel_l2(got, want) <= 0.05
    assert abs(norm_of(got) / norm_of(want) - 1) <= 1e-2
    total = norm_of(want)
    for n in want:
        if n.removesuffix(".bias") in ("basenet.slice5.2", "conv_cls.8"):  # the sum of the given cotangent
            assert rel_l2({n: got[n]}, {n: want[n]}) <= 2.0 ** -8, n
        elif norm_of({n: want[n]}) < 1e-2 * total:  # zero in exact arithmetic
            assert norm_of({n: got[n]}) <= 1e-2 * total, n
    if block != "basenet.slice1":  # the canvas takes no gradient
        dx = craft_blocks[block]["dx"]
        assert dx.dtype == BF16
        assert rel_l2({"dx": dx.float()}, {"dx": craft_ref["dx"][block].float()}) <= 0.05
    for k, t in craft_blocks[block]["stats"].items():
        assert rel_l2({k: t}, {k: craft_ref["stats"][k]}) <= 1e-2, k


def test_craft_bf16_gradient_block_by_block_matches_the_jax_step(craft_ref, craft_port, craft_blocks):
    """The whole gradient, each block's part taken on the JAX step's own
    input and output cotangent: within 0.05 relative L2 of the JAX step's,
    its norm within 1e-2, and at most 0.25x as far from it as the JAX
    bfloat16 step is from the float32 step."""
    got, want = {}, {}
    for block in BLOCKS:
        got.update(craft_blocks[block]["grads"])
        want.update(craft_block_reference(craft_ref, block))
    assert got.keys() == want.keys() == set(craft_ref["grads"])
    dist = rel_l2(got, want)
    assert dist <= 0.05
    assert abs(norm_of(got) / norm_of(want) - 1) <= 1e-2
    assert dist <= 0.25 * rel_l2(craft_ref["grads"], craft_port["grads32"])


# -- CRNN ------------------------------------------------------------------------

def host_batch(cfg):
    conv = jbuild_converter(cfg.prediction, cfg.character)
    batch = {"images": np.random.default_rng(0).standard_normal(
        (len(LABELS), cfg.height, cfg.width, 1)).astype(np.float32)}
    if cfg.prediction == "CTC":
        batch["labels"], batch["lengths"] = conv.encode_padded(LABELS, cfg.batch_max_len)
    else:
        batch["text"], batch["lengths"] = conv.encode(LABELS, cfg.batch_max_len)
    return batch


@pytest.fixture(scope="module", params=list(CASES))
def crnn_ref(request, refs):
    return refs[request.param]


def torch_batch(batch):
    return {k: torch.from_numpy(v) if k == "images" else torch.from_numpy(v).long()
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def crnn_port(crnn_ref):
    """The port's training loss and gradients on the same weights, from
    ``init_train_state(model=CRNNet(cfg, dtype=bfloat16))``, with forward
    hooks recording what each conv, Linear, LSTM and BatchNorm computed."""
    cfg = crnn_ref["cfg"]
    model, _ = init_train_state(cfg, 1, "cpu", model=CRNNet(cfg, dtype=BF16))
    model.load_state_dict(crnn_ref["net"].state_dict(), strict=True)
    seen = {"io": [], "bn": []}

    def io(m, args, out):
        seen["io"].append((type(m).__name__, args[0].dtype, (out[0] if isinstance(out, tuple) else out).dtype))

    def bn_pre(m, args):
        m._before = (m.running_mean.clone(), m.running_var.clone())

    def bn(m, args, out):
        x = args[0].detach().float()
        old_mean, old_var = m._before
        mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False)

        def off(new, want):
            return float((new - want).abs().max() / want.abs().max().clamp_min(1.0))

        seen["bn"].append((args[0].dtype, out.dtype, m.running_mean.dtype,
                           off(m.running_mean, 0.9 * old_mean + 0.1 * mean),
                           off(m.running_var, 0.9 * old_var + 0.1 * var)))

    hooks = []
    for m in model.modules():
        if isinstance(m, (Conv2d, Linear, LSTM)):
            hooks.append(m.register_forward_hook(io))
        elif isinstance(m, BatchNorm2d):
            hooks += [m.register_forward_pre_hook(bn_pre), m.register_forward_hook(bn)]
    loss, _ = loss_fn(model, cfg, torch_batch(crnn_ref["batch"]))
    for h in hooks:
        h.remove()
    loss.backward()
    return {"loss": loss.detach(), "grads": grads_of(model), "seen": seen, "model": model}


def test_crnn_bf16_loss_within_two_ulps_of_jax(crnn_ref, crnn_port):
    """The loss is a bfloat16 number on both sides (the attention cross
    entropy and the CTC recursion run in the logits' dtype)."""
    assert crnn_port["loss"].dtype == BF16 and crnn_ref["loss_dtype"] == jnp.bfloat16
    ref = crnn_ref["loss"]
    ulp = 2.0 ** (np.floor(np.log2(abs(ref))) - 7)
    assert abs(float(crnn_port["loss"]) - ref) <= 2 * ulp


@pytest.mark.parametrize("module", ["Prediction", "SequenceModeling"])
def test_crnn_bf16_head_gradients_match_jax(crnn_ref, crnn_port, module):
    """The gradients of the modules next to the loss within 10% relative L2
    (two XLA runs of the JAX step, strict and default rounding, differ
    there by up to 4.1%: ``scripts/torch_bf16_step_spread.py
    --xla-strict``)."""
    assert rel_l2(crnn_port["grads"], crnn_ref["grads"], module + ".") <= 0.1


def test_crnn_bf16_gradients_finite_and_float32(crnn_port):
    for n, p in crnn_port["model"].named_parameters():
        assert p.dtype == torch.float32, n
        assert np.isfinite(crnn_port["grads"][n]).all(), n


def test_crnn_bf16_layers_compute_in_bf16_and_batch_norm_in_float32(crnn_ref, crnn_port):
    """Every conv, Linear and LSTM takes and gives bfloat16; every BatchNorm
    gives bfloat16 and moves its float32 running statistics by the float32
    mean and biased variance of its input (a bfloat16 reduction would miss
    them by ~1e-3)."""
    io, bn = crnn_port["seen"]["io"], crnn_port["seen"]["bn"]
    kinds = {k for k, _, _ in io}
    assert {"QuantConv", "Linear", "LSTM"} <= kinds
    assert ("Conv2d" in kinds) == (crnn_ref["case"] == "TPS")  # the TPS head's convs
    assert all(i == BF16 and o == BF16 for _, i, o in io)
    assert bn and all(i == BF16 and o == BF16 and s == torch.float32 for i, o, s, _, _ in bn)
    assert max(max(dm, dv) for *_, dm, dv in bn) <= 1e-5


def test_crnn_bf16_eval_forward_matches_jax_init_crnn(crnn_ref):
    """``init_crnn(dtype=bfloat16)`` in ``eval()`` against the JAX
    ``init_crnn(dtype=bfloat16)`` model on the same weights: the logits
    within 8 bf16 ulps of the largest, and the repo's bfloat16 gate, the
    same transcripts and confidences within 0.05.  Random weights give
    near-uniform logits with bf16 ties, so a sample whose argmaxes first
    part at a near tie of the JAX logits (the top two within twice the
    largest difference) is held only up to there."""
    net, cfg = crnn_ref["net"].eval(), crnn_ref["cfg"]
    assert all(p.dtype == torch.float32 for p in net.parameters())
    with torch.no_grad():
        logits = net(torch.from_numpy(crnn_ref["batch"]["images"]))
    assert logits.dtype == BF16
    got, want = logits.float(), crnn_ref["logits"]
    diff = float((got - want).abs().max())
    assert diff <= 8 * 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    top2 = want.topk(2, dim=-1).values
    near_tie = top2[..., 0] - top2[..., 1] <= 2 * diff
    idx, conf = decode_preds(logits, cfg)
    jidx, jconf = decode_preds(want, cfg)
    for i, (a, b) in enumerate(zip(got.argmax(-1), want.argmax(-1))):
        parted = torch.nonzero(a != b)
        if len(parted):
            assert near_tie[i, parted[0, 0]], i
        else:
            assert torch.equal(idx[i], jidx[i]) and abs(float(conf[i] - jconf[i])) < 0.05, i


# -- one block alone: the rounding rule without the chaos of depth -------------------

def block_case(kind: str):
    """(the port's block in ``train()``, the JAX block in bfloat16, the JAX
    variables on the same seeded weights, a bfloat16 input and output
    cotangent, the JAX block's extra arguments) for a decoder ``UpConv``
    (64 -> 32 -> 16 at 16x16, b2), a ``BidirectionalLSTM`` (64 -> 32, 9
    frames, b4), a ResNet ``BasicBlock`` with its downsample (32 -> 64 at
    8x16, b4) or the ``TPS_STN`` (8 fiducials, a 32x64 crop to 16x32, b4;
    its ``localization_fc2`` drawn too, where the init's zero weight
    would pass no gradient to the localization network)."""
    rng = np.random.default_rng(7)
    if kind == "UpConv":
        port, jblock = UpConv(64, 32, 16), JUpConv(32, 16, dtype=jnp.bfloat16)
        x_shape, y_shape, args = (2, 16, 16, 64), (2, 16, 16, 16), (True,)
    elif kind == "BiLSTM":
        port, jblock = BidirectionalLSTM(64, 32, 32), JBidirectionalLSTM(32, 32, dtype=jnp.bfloat16)
        x_shape, y_shape, args = (4, 9, 64), (4, 9, 32), ()
    elif kind == "BasicBlock":
        port, jblock = BasicBlock(32, 64), JBasicBlock(64, downsample=True, dtype=jnp.bfloat16)
        x_shape, y_shape, args = (4, 8, 16, 32), (4, 8, 16, 64), (True,)
    else:
        port, jblock = TPS_STN(8, 16, 32, 1), JTPS_STN(8, 16, 32, dtype=jnp.bfloat16)
        x_shape, y_shape, args = (4, 32, 64, 1), (4, 16, 32, 1), (True,)
    init_train_params(port, torch.Generator().manual_seed(0)).train()
    if kind == "TPS":
        fc2 = port.LocalizationNetwork.localization_fc2
        fc2.weight.data = 0.05 * torch.from_numpy(rng.standard_normal(fc2.weight.shape).astype(np.float32))
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.key(0), jnp.zeros(x_shape, jnp.bfloat16), *args))
    v = import_torch_state_dict(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes),
                                {k: t.numpy() for k, t in port.state_dict().items()})
    x = jnp.asarray(rng.standard_normal(x_shape), jnp.bfloat16)
    g = jnp.asarray(rng.standard_normal(y_shape), jnp.bfloat16)
    return port, jblock, v, x, g, args


def to_torch(a) -> torch.Tensor:
    """A JAX bfloat16 array as a torch bfloat16 tensor, NHWC as NCHW."""
    t = torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(BF16)
    return t.permute(0, 3, 1, 2) if t.ndim == 4 else t


def strict(f, *args):
    """``jax.jit(f)(*args)`` with every op rounded to its dtype, as the JAX
    program is written and as the port computes (XLA's default,
    ``xla_allow_excess_precision``, keeps some float32 results through a
    fused op: a BatchNorm's output into the ResNet block's residual sum,
    a conv's output into its BatchNorm; the port's blocks are then 4-6%
    from it, within 1% of the strict program)."""
    return jax.jit(f).lower(*args).compile({"xla_allow_excess_precision": False})(*args)


# each block's tolerance on its outputs and gradients, relative L2
BLOCK_TOL = {"UpConv": 1.6e-2, "BiLSTM": 3e-2, "BasicBlock": 1.6e-2}


@pytest.mark.parametrize("kind", list(BLOCK_TOL))
def test_bf16_block_forward_and_backward_match_jax(kind):
    """One block in bfloat16 on float32 parameters, the same input and
    output cotangent on both sides, so no chaos of depth, against the JAX
    block with every op rounded (:func:`strict`).  The blocks with a
    training BatchNorm (the decoder block and the ResNet block with its
    downsample: convs, BatchNorm, ReLU, the residual sum) give at least 99%
    of the JAX block's output bit for bit (the rest one ulp off: 1e-3
    relative L2) and their gradients within 1.6e-2 relative L2 (4x
    bfloat16's unit round-off; the BatchNorm backward is another float32
    formula, rounded once); the BiLSTM (a 9-step recurrence that rounds
    where XLA rounds otherwise) output and gradients within 3e-2.  The
    biases of the convs before a BatchNorm have a zero gradient, round-off
    on both sides: held to 1e-2 of the block's gradient norm."""
    port, jblock, v, x, g, args = block_case(kind)
    params = v["params"]

    def apply(p, x):
        if "batch_stats" in v:
            return jblock.apply({"params": p, "batch_stats": v["batch_stats"]}, x, *args,
                                mutable=["batch_stats"])[0]
        return jblock.apply({"params": p}, x, *args)

    def forward_backward(p, x, g):
        y, vjp = jax.vjp(apply, p, x)
        return y, vjp(g)

    want, (jgrads, jdx) = strict(forward_backward, params, x, g)
    want, jdx, tx, tg = map(to_torch, (want, jdx, x, g))
    tx.requires_grad_(True)
    got = port(tx)
    got.backward(tg)
    assert got.dtype == BF16 and tx.grad.dtype == BF16
    jg = to_state_dict({"params": jgrads})
    total = norm_of(jg)
    tol = BLOCK_TOL[kind]
    y = rel_l2({"y": got.detach().float()}, {"y": want.float()})
    if kind != "BiLSTM":  # a BatchNorm output a float32 rounding from a bf16 tie flips by an ulp
        assert float((got.detach() == want).float().mean()) >= 0.99 and y <= 1e-3
    else:
        assert y <= tol
    assert rel_l2({"dx": tx.grad.float()}, {"dx": jdx.float()}) <= tol
    assert jg.keys() == dict(port.named_parameters()).keys()
    for n, p in port.named_parameters():
        if norm_of({n: jg[n]}) < 1e-2 * total:  # zero in exact arithmetic, bf16 sums on the JAX side
            assert norm_of({n: p.grad}) <= 1e-2 * total, n
        else:
            assert rel_l2({n: p.grad}, {n: jg[n]}) <= tol, n


TPS_TAPS = {"0": (4, 32, 64, 1), "4": (4, 16, 32, 64), "8": (4, 8, 16, 128), "12": (4, 4, 8, 256),
            "head": (4, 2, 4, 512), "out": (4, 8, 2)}  # the localization network's units, head, output


@pytest.fixture(scope="module")
def tps_ref():
    """The TPS block of :func:`block_case`, its JAX localization network
    tapped by ``flax.linen.intercept_methods`` (a zero added, so the block
    is unchanged) at the input of each conv unit (named by its conv), of
    the head and at its output, every op rounded (:func:`strict`): (the
    port's block, ``{tap: (value, cotangent)}`` NCHW, the JAX gradients)."""
    port, jblock, v, x, g, args = block_case("TPS")

    def forward_backward(p, x, g, zero):
        def run(p, x, zero):
            taps = {}

            def tap(next_fun, args, kwargs, ctx):
                path = ctx.module.path
                if ctx.method_name != "__call__" or path[:1] != ("LocalizationNetwork",):
                    return next_fun(*args, **kwargs)
                if path == ("LocalizationNetwork",):
                    taps["out"] = next_fun(*args, **kwargs) + zero["out"]
                    return taps["out"]
                if path == ("LocalizationNetwork", "conv"):
                    taps["head"] = next_fun(*args, **kwargs) + zero["head"]
                    return taps["head"]
                if path[1:2] == ("conv",) and path[2] in TPS_TAPS:
                    taps[path[2]] = args[0] + zero[path[2]]
                    return next_fun(taps[path[2]], *args[1:], **kwargs)
                return next_fun(*args, **kwargs)

            with nn.intercept_methods(tap):
                y = jblock.apply({"params": p, "batch_stats": v["batch_stats"]}, x, True,
                                 mutable=["batch_stats"])[0]
            return y, taps

        _, vjp, taps = jax.vjp(run, p, x, zero, has_aux=True)
        return taps, vjp(g)

    zero = {k: jnp.zeros(shape, jnp.bfloat16) for k, shape in TPS_TAPS.items()}
    taps, (grads, _, dtaps) = strict(forward_backward, v["params"], x, g, zero)
    return port, {k: (to_torch(taps[k]), to_torch(dtaps[k])) for k in TPS_TAPS}, to_state_dict({"params": grads})


@pytest.mark.parametrize("unit", ["0", "4", "8", "12", "head"])
def test_bf16_tps_localization_by_unit_matches_jax(tps_ref, unit):
    """The TPS's localization network (its ``localization_fc2`` drawn), one
    unit at a time on the JAX block's own input and output cotangent,
    every op rounded on both sides: each conv unit (conv, training
    BatchNorm, ReLU, 2x2 max pool) and the head (mean, two Linears) give
    their gradients and input cotangent within 1.6e-2 relative L2.
    (Whole, the network's deep gradients part by 8%: a conv output an ulp
    apart moves a 2x2 max pool's choice, and the network ends in a mean
    whose cotangent its last BatchNorm's backward mostly cancels.)"""
    port, taps, jg = tps_ref
    net = port.LocalizationNetwork
    names = list(TPS_TAPS)
    x, jdx = taps[unit]
    x = x.clone().requires_grad_(True)
    net.zero_grad(set_to_none=True)
    y = net.head(x) if unit == "head" else net.unit(names.index(unit), x)
    y.backward(taps[names[names.index(unit) + 1]][1])
    assert x.grad.dtype == BF16
    assert rel_l2({"dx": x.grad.float()}, {"dx": jdx.float()}) <= 1.6e-2
    got = {f"LocalizationNetwork.{n}": p.grad for n, p in net.named_parameters() if p.grad is not None}
    assert got
    for n, grad in got.items():
        assert rel_l2({n: grad}, {n: jg[n]}) <= 1.6e-2, n


def test_bf16_tps_sampling_matches_jax(tps_ref):
    """The TPS after its localization network, both sides given the same
    fiducial points (the JAX network's output and cotangent of
    ``tps_ref``), crop and output cotangent, every op rounded: the float32
    TPS grid rounded to bfloat16, the bilinear sample in float32 rounded
    once, its backward to the crop and to the fiducial points, each within
    3e-2 relative L2.  (A bfloat16 fiducial an ulp apart moves the grid by
    up to 0.004 of the crop's width, a noise crop's samples by ~10%: so the
    localization network is held apart.)"""
    port, taps, _ = tps_ref
    _, jblock, v, x, g, _ = block_case("TPS")
    c = jnp.asarray(taps["out"][0].float().numpy(), jnp.bfloat16)

    def forward_backward(c, x, g):
        def run(c, x):
            def given(next_fun, args, kwargs, ctx):
                if ctx.method_name == "__call__" and ctx.module.path == ("LocalizationNetwork",):
                    return c
                return next_fun(*args, **kwargs)

            with nn.intercept_methods(given):
                return jblock.apply(v, x, True, mutable=["batch_stats"])[0]

        y, vjp = jax.vjp(run, c, x)
        return y, vjp(g)

    want, (jdc, jdx) = strict(forward_backward, c, x, g)
    tc, tx = to_torch(c).requires_grad_(True), to_torch(x).requires_grad_(True)
    hook = port.LocalizationNetwork.register_forward_hook(lambda m, a, out: tc)
    got = port(tx)
    hook.remove()
    got.backward(to_torch(g))
    assert got.dtype == tx.grad.dtype == tc.grad.dtype == BF16
    for a, b in ((got.detach(), want), (tx.grad, jdx), (tc.grad, jdc)):
        assert rel_l2({"a": a.float()}, {"a": to_torch(b).float()}) <= 3e-2


# -- the dtype rule, round trips, refusals -----------------------------------------

@pytest.mark.parametrize("shape", [(8, 8, 16, 16), (4, 6, 8, 12), (16, 12, 32, 24), (5, 7, 11, 13)])
def test_bf16_upsample_rounds_as_jax_image_resize(shape):
    """The decoder's bilinear upsampling in bfloat16, forward and backward,
    bit for bit ``jax.image.resize``'s (one contraction an axis, each
    rounded, in ``jnp.einsum``'s order)."""
    from lightly_ocr_tpu.models.vgg_unet import _upsample_to as jupsample
    from lightly_ocr_tpu_torch.models.vgg_unet import _upsample_to

    h, w, H, W = shape
    rng = np.random.default_rng(sum(shape))
    x = jnp.asarray(rng.standard_normal((2, h, w, 8)), jnp.bfloat16)
    g = jnp.asarray(rng.standard_normal((2, H, W, 8)), jnp.bfloat16)
    want, vjp = jax.vjp(lambda t: jupsample(t, H, W), x)

    def nchw(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(BF16).permute(0, 3, 1, 2)

    t = nchw(x).requires_grad_(True)
    got = _upsample_to(t, H, W)
    got.backward(nchw(g))
    assert torch.equal(got.detach(), nchw(want))
    assert torch.equal(t.grad, nchw(vjp(g)[0]))


@pytest.mark.parametrize("kind", ["VGG_UNet", "CRNNet"])
def test_double_and_serving_ignore_the_compute_dtype(kind):
    """Cast parameters decide the compute dtype: a model built with
    ``dtype=bfloat16`` computes in float64 after ``.double()`` bit for bit
    as the float32 default does (the float64 parity tests' path), and after
    ``to_serving(bfloat16)`` every conv and Linear uses its own parameter
    tensors, uncast."""
    cfg = Config(**SMALL, **CASES["TPS"])
    weights = init_train_params(VGG_UNet() if kind == "VGG_UNet" else CRNNet(cfg),
                                torch.Generator().manual_seed(0)).state_dict()

    def build(dtype):
        net = VGG_UNet(dtype=dtype) if kind == "VGG_UNet" else CRNNet(cfg, dtype=dtype)
        net.load_state_dict(weights, strict=True)
        return net.eval()

    x = torch.rand(2, 32, 32, 3 if kind == "VGG_UNet" else 1, dtype=torch.float64)
    with torch.no_grad():
        a, b = build(BF16).double()(x), build(torch.float32).double()(x)
    a, b = (a[0], b[0]) if kind == "VGG_UNet" else (a, b)
    assert a.dtype == torch.float64 and torch.equal(a, b)
    served = to_serving(build(torch.float32), "cpu", BF16)
    layers = [m for m in served.modules() if isinstance(m, (Conv2d, Linear))]
    probe = torch.zeros(1, dtype=BF16)
    assert layers and all(cast_to(m.weight, probe) is m.weight for m in layers)


@pytest.mark.parametrize("axis", ["data", "model"])
@pytest.mark.parametrize("which", ["craft", "crnn"])
def test_reduced_dtype_with_a_group_raises(which, axis):
    groups = MeshGroups(data_size=2) if axis == "data" else MeshGroups(model_size=2)
    cfg = Config(**SMALL, **CASES["CTC"])
    with pytest.raises(ValueError, match="bfloat16.*2x1" if axis == "data" else "bfloat16.*1x2"):
        if which == "craft":
            craft.init_craft_state(0, device="cpu", group=groups, dtype=BF16)
        else:
            init_train_state(cfg, 0, "cpu", groups, model=CRNNet(cfg, dtype=BF16))


def test_init_crnn_is_init_train_states_init():
    """``init_crnn`` and ``init_train_state`` draw the same weights from a
    seed; ``init_crnn`` keeps them float32 whatever its dtype."""
    cfg = Config(**SMALL, **CASES["TPS"])
    a = init_crnn(cfg, 3, BF16, "cpu").state_dict()
    b = init_train_state(cfg, 3, "cpu")[0].state_dict()
    assert a.keys() == b.keys()
    assert all(a[k].dtype == b[k].dtype == torch.float32 and torch.equal(a[k], b[k]) for k in a)
