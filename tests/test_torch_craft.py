"""CRAFT detector training of the PyTorch port vs the JAX package (CPU).

The synthetic data, the pseudo-labels and the detection records are numpy
on both sides and must be bit-identical (the port's PIL-free bilinear
resize is PIL's, bit for bit).  The OHEM threshold must be equal and its
loss within 1e-6.  One train step of ``VGG_UNet`` at b2, 64x64 is compared
in float64 on both sides (JAX with ``jax_enable_x64``, the port's model
``.double()``, the JAX init carried across with
``state_dict_from_variables``): the loss, every gradient, the BatchNorm
statistics, the parameters after the Adam update (with and without
``freeze=("slice1",)``) and the reported gradient norm, each tensor within
1e-8 relative L2.  The JAX package's model is compiled once, in a
module-scoped fixture.
"""
import contextlib
import io
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from PIL import Image

from lightly_ocr_tpu.models.vgg_unet import VGG_UNet as JVGG_UNet
from lightly_ocr_tpu.train import craft as jcraft
from lightly_ocr_tpu.train import pseudo_labels as jpl
from lightly_ocr_tpu_torch.data.loader import resize_bilinear_uint8
from lightly_ocr_tpu_torch.data.records import RecordDataset
from lightly_ocr_tpu_torch.models.vgg_unet import _VGG_SLICES, VGG_UNet
from lightly_ocr_tpu_torch.train import craft
from lightly_ocr_tpu_torch.train import pseudo_labels as pl
from lightly_ocr_tpu_torch.train.train_step import TrainState
from lightly_ocr_tpu_torch.utils.checkpoint import load_state_file, restore_checkpoint
from lightly_ocr_tpu_torch.parallel.launch import spawn
from lightly_ocr_tpu_torch.weights import state_dict_from_variables
from torch_dp_workers import assert_step_equal, run_cases

HW = 64  # the step's canvas: 64x64, batch 2
REL = 1e-8  # relative L2 of each float64 tensor


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs (several test processes
    share the machine's cores under pytest-xdist)."""
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


def to_state_dict(params, stats=None):
    tree = {"params": jax.tree.map(np.asarray, params)}
    if stats is not None:
        tree["batch_stats"] = jax.tree.map(np.asarray, stats)
    return state_dict_from_variables(tree, np.float64)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's step pieces at b2, 64x64: its init (float32), and
    in float64 the loss, gradients, batch statistics after the forward, the
    gradient norm, the parameters after one Adam update with and without
    the freeze, and the eval-mode region maps of the init."""
    batch = jcraft.synthesize_batch(np.random.default_rng(11), 2, HW, HW)
    model = JVGG_UNet()
    v = jax.jit(lambda r: model.init(r, jnp.zeros((1, HW, HW, 3)), True))(jax.random.key(0))
    v = jax.tree.map(np.asarray, v)
    out = {"batch": batch, "variables": v,
           "init32": {k: t.float() for k, t in to_state_dict(v["params"], v["batch_stats"]).items()},
           "eval_maps": np.asarray(jax.jit(lambda x: model.apply(v, x, False)[0])(
               jnp.asarray(batch["images"])))}
    with x64():
        m64 = JVGG_UNet(dtype=jnp.float64)
        params, stats = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v[k])
                         for k in ("params", "batch_stats"))
        jb = {k: jnp.asarray(a) for k, a in batch.items()}

        def loss_fn(p, s, b):  # train_craft's loss, the maps left in float64
            (maps, _), new = m64.apply({"params": p, "batch_stats": s}, b["images"].astype(jnp.float64),
                                       True, mutable=["batch_stats"])
            loss = jcraft.ohem_mse(maps[..., 0], b["region"]) + jcraft.ohem_mse(maps[..., 1], b["affinity"])
            return loss, new["batch_stats"]

        (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, stats, jb)
        out.update(loss=float(loss), grad_norm=float(optax.global_norm(grads)),
                   init64=to_state_dict(params, stats), grads=to_state_dict(grads),
                   stats=to_state_dict(params, new_stats))
        for freeze in ((), ("slice1",)):
            opt = jcraft.make_craft_optimizer(1e-3, 5.0, freeze=freeze)
            upd, _ = jax.jit(opt.update)(grads, opt.init(params), params)
            out[freeze] = to_state_dict(optax.apply_updates(params, upd), new_stats)
    return out


def zero_gradients(ref) -> tuple[set, float]:
    """(the parameters whose gradient is zero, the global gradient norm).
    The bias of a conv that feeds a BatchNorm has a zero gradient: both
    sides give round-off there (~1e-17), so such a tensor is held to zero,
    not to the other side's round-off."""
    total = np.sqrt(sum(float((g.numpy() ** 2).sum()) for g in ref["grads"].values()))
    zero = {n for n, g in ref["grads"].items() if np.linalg.norm(g.numpy()) < 1e-12 * total}
    assert zero and all(n.endswith("bias") for n in zero)
    return zero, total


def port_model(ref, dtype=torch.float64) -> VGG_UNet:
    net = VGG_UNet()
    net.load_state_dict(ref["init64"], strict=True)
    return net.to(dtype).train()


def torch_batch(batch, dtype=torch.float64):
    return {k: torch.from_numpy(v).to(dtype if k == "images" else torch.float32) for k, v in batch.items()}


# -- synthetic data and pseudo-labels: bit-identical --------------------------

@pytest.mark.parametrize("seed,b,h,w", [(0, 2, 128, 96), (7, 3, 256, 192), (3, 1, 64, 64)])
def test_synthesize_batch_is_bit_identical(seed, b, h, w):
    got = craft.synthesize_batch(np.random.default_rng(seed), b, h, w)
    want = jcraft.synthesize_batch(np.random.default_rng(seed), b, h, w)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["region"].max() > 0.9 and got["affinity"].max() > 0.9


@pytest.mark.parametrize("shape,hw", [((80, 120, 3), (64, 96)), ((37, 53, 3), (91, 29)),
                                      ((100, 200, 3), (50, 100)), ((33, 17, 3), (7, 5)),
                                      ((64, 48, 3), (320, 256)), ((601, 399, 3), (123, 777))],
                         ids=["shrink", "odd", "half", "tiny", "grow", "mixed"])
def test_bilinear_resize_is_pils(shape, hw):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize(hw[::-1], Image.BILINEAR))
    np.testing.assert_array_equal(resize_bilinear_uint8(img, hw[1], hw[0]), want)


def _word_scene(rng, h=90, w=150):
    """A gray page with two words of dark glyph blocks; (gray, words)."""
    gray = np.full((h, w), 235.0, np.float32) + rng.normal(0, 5, (h, w)).astype(np.float32)
    words = []
    for r, n in ((10, 5), (50, 3)):
        c = int(rng.integers(4, 20))
        c0 = c
        for _ in range(n):
            cw = int(rng.integers(9, 16))
            gray[r: r + 22, c: c + cw] = rng.uniform(20, 80, (22, cw))
            c += cw + int(rng.integers(2, 8))
        words.append({"rect": [r - 2.5, c0 - 1.5, r + 24.3, c + 1.2], "text": "abcdefgh"[:n]})
    return gray, words


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_char_boxes_and_targets_are_bit_identical(seed):
    gray, words = _word_scene(np.random.default_rng(seed))
    boxes = []
    for wd in words + [{"rect": [0, 0, 90, 150], "text": "x"}, {"rect": [5, 5, 20, 9], "text": "wide"}]:
        got = pl.char_boxes_from_word(gray, wd["rect"], wd["text"])
        np.testing.assert_array_equal(got, jpl.char_boxes_from_word(gray, wd["rect"], wd["text"]))
        boxes.append(got)
    np.testing.assert_array_equal(pl._ink_profile(gray[10:32, 4:80]), jpl._ink_profile(gray[10:32, 4:80]))
    for a, b in zip(pl.render_craft_targets(45, 75, boxes), jpl.render_craft_targets(45, 75, boxes)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", [(64, 96), (45, 151), (200, 320)], ids=["shrink", "odd", "grow"])
def test_sample_to_training_item_is_bit_identical(hw):
    rng = np.random.default_rng(hw[0])
    gray, words = _word_scene(rng)
    img = np.clip(np.repeat(gray[..., None], 3, -1) + rng.integers(-9, 9, (*gray.shape, 3)), 0,
                  255).astype(np.uint8)
    got = pl.sample_to_training_item(img, words, *hw)
    want = jpl.sample_to_training_item(img, words, *hw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _receipts(rng, n):
    out = []
    for _ in range(n):
        gray, words = _word_scene(rng)
        out.append((np.repeat(np.clip(gray, 0, 255).astype(np.uint8)[..., None], 3, -1), words))
    return out


@pytest.mark.parametrize("pil", [True, False], ids=["pil", "numpy_png"])
def test_detection_records_and_batches_equal_jax(tmp_path, monkeypatch, pil):
    """Records written by the port (PNG without PIL) decode under PIL to the
    same pixels; the port's batches (its PNG decode with PIL, or without
    it) equal the JAX package's for the same ``rng``, bit for bit."""
    samples = _receipts(np.random.default_rng(5), 4)
    path = str(tmp_path / "det.lor")
    assert pl.write_detection_records(path, iter(samples)) == 4
    ds = RecordDataset(path, filtering=False)
    for i, (img, words) in enumerate(samples):
        label, blob = ds.raw(i)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(blob)).convert("RGB")), img)
        assert pl._decode_sample(label, blob)[1] == words
    ds.close()
    want = jpl.batches_from_records(path, 3, 64, 96, np.random.default_rng(2))
    want = [next(want) for _ in range(3)]
    if not pil:
        monkeypatch.setitem(sys.modules, "PIL", None)
    got = pl.batches_from_records(path, 3, 64, 96, np.random.default_rng(2))
    for g, w in zip([next(got) for _ in range(3)], want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    got.close()
    # a process's rows of each global batch (data-parallel): the same rows,
    # decoding only those
    for rows in (slice(0, 1), slice(1, 3)):
        part = pl.batches_from_records(path, 3, 64, 96, np.random.default_rng(2), rows=rows)
        for g, w in zip([next(part) for _ in range(3)], want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k][rows], err_msg=k)
        part.close()
    assert pl.write_detection_records(str(tmp_path / "e.lor"), iter([])) == 0
    with pytest.raises(ValueError, match="empty"):
        next(pl.batches_from_records(str(tmp_path / "e.lor"), 1, 8, 8, np.random.default_rng(0)))


# -- OHEM ----------------------------------------------------------------

def _fields():
    rng = np.random.default_rng(4)
    region = jcraft.synthesize_batch(np.random.default_rng(1), 2, 96, 64)["region"]
    pred = rng.standard_normal((2, 48, 32)).astype(np.float32) * 0.3
    return {"synthetic": (pred, region),
            "sparse": (pred, (rng.random((2, 48, 32)) > 0.995).astype(np.float32)),
            "no_positives": (pred, np.zeros_like(region)),
            "all_positive": (pred, np.full_like(region, 0.5)),
            "ties": (np.round(pred, 1), np.round(region, 1))}


@pytest.mark.parametrize("name", list(_fields()))
def test_ohem_threshold_and_loss_match_jax(name):
    pred, target = _fields()[name]
    err = (pred - target) ** 2
    neg = np.where(target > 0.1, 0.0, err).reshape(-1).astype(np.float32)
    for k in (0, 1, 17, 300, neg.size - 1):
        got = craft._kth_largest_threshold(torch.from_numpy(neg), torch.tensor(k, dtype=torch.int32))
        want = jcraft._kth_largest_threshold(jnp.asarray(neg), jnp.int32(k))
        assert got.item() == float(want), k
    got = craft.ohem_mse(torch.from_numpy(pred), torch.from_numpy(target)).item()
    want = float(jcraft.ohem_mse(jnp.asarray(pred), jnp.asarray(target)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


# -- the train step (float64) ----------------------------------------------

def test_train_loss_gradients_and_batch_stats_match_jax(ref):
    net = port_model(ref)
    loss = craft.craft_loss(net, torch_batch(ref["batch"]))
    loss.backward()
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=REL)
    grads = {n: p.grad for n, p in net.named_parameters()}
    assert grads.keys() == ref["grads"].keys()
    zero, total = zero_gradients(ref)
    for n in zero:
        assert np.linalg.norm(grads[n].numpy()) < 1e-12 * total, n
    worst = max(grads.keys() - zero, key=lambda n: rel_l2(grads[n], ref["grads"][n]))
    assert rel_l2(grads[worst], ref["grads"][worst]) <= REL, worst
    stats = {k: v for k, v in net.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    assert len(stats) == 2 * sum(1 for k in ref["stats"] if k.endswith("running_mean"))
    for k, v in stats.items():
        assert rel_l2(v, ref["stats"][k]) <= REL, k


@pytest.mark.parametrize("freeze", [(), ("slice1",)], ids=["plain", "freeze_slice1"])
def test_train_step_matches_jax(ref, freeze):
    """One ``make_craft_train_step`` step: every tensor of the state after
    it (parameters after Adam, BatchNorm statistics) and the loss and raw
    gradient norm within 1e-8 of the JAX package's; under the freeze the
    slice1 parameters are unchanged and its running statistics moved."""
    net = port_model(ref)
    state = TrainState(net, craft.make_craft_optimizer(net.parameters(), 1e-3))
    state, metrics = craft.make_craft_train_step(net, freeze=freeze)(state, torch_batch(ref["batch"]))
    assert state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(), ref["loss"], rtol=REL)
    np.testing.assert_allclose(metrics["grad_norm"].item(), ref["grad_norm"], rtol=REL)
    got, want = net.state_dict(), ref[freeze]
    assert got.keys() == want.keys()
    zero, _ = zero_gradients(ref)
    for k in want:
        if k in zero:  # zero at init, moved by Adam's lr * g / (|g| + eps) of round-off g
            assert np.abs(got[k].numpy()).max() < 1e-9 and np.abs(want[k].numpy()).max() < 1e-9, k
        else:
            assert rel_l2(got[k], want[k]) <= REL, k
        if k.startswith("basenet.slice1.") and freeze:
            moved = not torch.equal(got[k], ref["init64"][k])
            assert moved == k.endswith(("running_mean", "running_var")), k


def test_two_rank_step_matches_jax(ref):
    """The data-parallel step with slice1 frozen over two gloo ranks
    (spawned, one thread each; one image each) equals the JAX package's
    single-device float64 step on both images: loss 1e-10, every gradient
    and every tensor after the update within 1e-8 relative L2, the frozen
    gradients zero and slice1's parameters unchanged.  The two images hold
    different numbers of positive pixels, so a per-shard OHEM (``min``,
    ``max``, ``num_pos``, the halvings' counts), normaliser or BatchNorm
    fails it."""
    pos = (ref["batch"]["region"] > 0.1).sum((1, 2))
    assert pos[0] != pos[1]
    payload = {"init": ref["init64"], "freeze": ("slice1",), "batch": torch_batch(ref["batch"])}
    got = spawn(run_cases, ({"craft": ("craft", payload)},), ["cpu", "cpu"])["craft"]
    frozen = {n for n in ref["grads"] if n.startswith("basenet.slice1.")}
    assert_step_equal(got, ref["loss"], ref["grads"], ref[("slice1",)], ref["init64"], frozen=frozen)


@pytest.mark.parametrize("trainable_scale", [0.5, 40.0], ids=["under_clip", "over_clip"])
def test_frozen_gradients_are_out_of_the_clip(trainable_scale):
    """A frozen gradient far above the clip: the trainable update equals
    the JAX masked chain's (which zeroes frozen gradients before the clip),
    whether the trainable gradients alone are under the clip or over it;
    the frozen parameter does not move; the reported norm counts it."""
    rng = np.random.default_rng(6)
    net = torch.nn.ModuleDict({"basenet": torch.nn.ModuleDict({"slice1": torch.nn.Linear(3, 4)}),
                               "upconv1": torch.nn.Linear(4, 2)})
    params = dict(net.named_parameters())
    p0 = {n: rng.standard_normal(p.shape) for n, p in params.items()}
    g = {n: rng.standard_normal(p.shape) * (1e4 if n.startswith("basenet") else trainable_scale)
         for n, p in params.items()}
    jtree = lambda d: {"basenet": {"slice1": {k: jnp.asarray(d[f"basenet.slice1.{k}"]) for k in ("weight", "bias")}},
                       "upconv1": {k: jnp.asarray(d[f"upconv1.{k}"]) for k in ("weight", "bias")}}  # noqa: E731
    with x64():
        opt = jcraft.make_craft_optimizer(1e-3, 5.0, freeze=("slice1",))
        jp = jtree(p0)
        upd, _ = opt.update(jtree(g), opt.init(jp), jp)
        after = jax.tree.map(np.asarray, optax.apply_updates(jp, upd))
    net.double()
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(torch.from_numpy(p0[n]))
    for n, p in net.named_parameters():
        p.grad = torch.from_numpy(g[n].copy())
    norm = craft.apply_craft_update(craft.make_craft_optimizer(net.parameters(), 1e-3),
                                    list(net.parameters()), craft.frozen_mask(net, ("slice1",)))
    np.testing.assert_allclose(norm.item(), np.sqrt(sum((v ** 2).sum() for v in g.values())), rtol=1e-12)
    for n, p in net.named_parameters():
        head, leaf = n.rsplit(".", 1)
        want = after["upconv1"][leaf] if head == "upconv1" else after["basenet"]["slice1"][leaf]
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-12, atol=1e-15, err_msg=n)
        if head != "upconv1":
            np.testing.assert_array_equal(p.detach().numpy(), p0[n])
    with pytest.raises(ValueError, match="slice_1"):
        craft.frozen_mask(net, ("slice_1",))


def test_eval_region_iou_matches_jax(ref):
    net = VGG_UNet()
    net.load_state_dict(ref["init32"], strict=True)
    net.train()
    for thresh in (0.0, 0.05, -0.05):
        got = pl.eval_region_iou(net, ref["batch"], thresh=thresh)
        assert net.training  # the mode is put back
        pred, tgt = ref["eval_maps"][..., 0] > thresh, ref["batch"]["region"] > thresh
        want = float((pred & tgt).sum() / max((pred | tgt).sum(), 1))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_quant_training_is_refused():
    net = VGG_UNet(quant=True).train()
    with pytest.raises(ValueError, match="inference-only"):
        net(torch.zeros(1, 32, 32, 3))


# -- the torchvision backbone init -------------------------------------------

def _torchvision_features(net: VGG_UNet, rng) -> dict:
    """A torchvision-keyed ``vgg16_bn`` features dict with the basenet's
    shapes (numpy)."""
    sd = {}
    for slice_name, ops in _VGG_SLICES.items():
        mods = getattr(net.basenet, slice_name)
        for op in ops:
            if op[0] == "C":
                i = op[1]
                cout = mods[str(i)].weight.shape[0]
                sd[f"features.{i}.weight"] = rng.standard_normal(tuple(mods[str(i)].weight.shape)).astype(np.float32)
                for k in ("bias",):
                    sd[f"features.{i}.{k}"] = rng.standard_normal(cout).astype(np.float32)
                for k in ("weight", "bias", "running_mean"):
                    sd[f"features.{i + 1}.{k}"] = rng.standard_normal(cout).astype(np.float32)
                sd[f"features.{i + 1}.running_var"] = np.abs(rng.standard_normal(cout)).astype(np.float32)
                sd[f"features.{i + 1}.num_batches_tracked"] = np.int64(3)
    return sd


@pytest.mark.parametrize("form", ["features", "bare", "pth"])
def test_backbone_init_lands_where_jax_puts_it(ref, tmp_path, form):
    v = ref["variables"]
    net = VGG_UNet()
    net.load_state_dict(ref["init32"], strict=True)
    sd = _torchvision_features(net, np.random.default_rng(8))
    want = state_dict_from_variables(jcraft.load_torchvision_backbone(v, sd))
    source = sd
    if form == "bare":
        source = {k.split(".", 1)[1]: x for k, x in sd.items()}
    elif form == "pth":
        source = str(tmp_path / "vgg16_bn.pth")
        torch.save({f"module.{k}": torch.from_numpy(np.asarray(x)) for k, x in sd.items()}, source)
    craft.load_torchvision_backbone(net, source)
    got = net.state_dict()
    assert got.keys() == want.keys()
    changed = 0
    for k in want:
        torch.testing.assert_close(got[k], want[k].float(), rtol=0, atol=0, msg=k)
        changed += not torch.equal(got[k], ref["init32"][k])
    n_convs = sum(op[0] == "C" for ops in _VGG_SLICES.values() for op in ops)
    assert changed == 6 * n_convs == 72  # each conv and its BatchNorm in slices 1-4


def test_backbone_init_refuses_a_bad_source(ref):
    net = VGG_UNet()
    sd = _torchvision_features(net, np.random.default_rng(9))
    bad = dict(sd, **{"features.0.weight": sd["features.0.weight"][:32]})
    with pytest.raises(ValueError, match="shape"):
        craft.load_torchvision_backbone(net, bad)
    with pytest.raises(KeyError):
        craft.load_torchvision_backbone(net, {k: x for k, x in sd.items() if k != "features.37.bias"})


# -- the state, the loop, the CLI ---------------------------------------------

def test_init_craft_state_defaults_to_the_card():
    import inspect

    assert inspect.signature(craft.init_craft_state).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        net, _ = craft.init_craft_state(0)
        assert next(net.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            craft.init_craft_state(0)
    with pytest.raises(ValueError, match="slice9"):
        craft.init_craft_state(0, device="cpu", freeze=("slice9",))


def test_cli_trains_and_checkpoints(tmp_path, capsys):
    """``trainer --model CRAFT --device cpu`` runs two steps and writes a
    checkpoint equal bit for bit to what ``train_craft`` makes in-process
    from the same arguments; ``restore_checkpoint`` reads it back."""
    from lightly_ocr_tpu_torch.train.trainer import main

    args = ["--num-steps", "2", "--batch", "1", "--height", str(HW), "--width", str(HW), "--seed", "3",
            "--freeze", "slice1", "--log-every", "1"]
    assert main(["--model", "CRAFT", "--device", "cpu", *args, "--checkpoint-dir", str(tmp_path / "cli")]) == 0
    out = capsys.readouterr().out
    assert "craft training on device cpu" in out and "final loss" in out and "craft step 2/2" in out
    model, state, losses = craft.train_craft(num_steps=2, batch=1, height=HW, width=HW, seed=3,
                                             device="cpu", log_every=0, freeze=("slice1",))
    assert len(losses) == 2 and all(np.isfinite(losses)) and state.step == 2
    saved, step = load_state_file(str(tmp_path / "cli"))
    assert step == saved["step"] == 2
    for k, t in model.state_dict().items():
        assert torch.equal(saved["model"][k], t), k
    _, fresh = craft.init_craft_state(9, device="cpu")
    fresh, step = restore_checkpoint(str(tmp_path / "cli"), fresh)
    assert step == fresh.step == 2
    for k, t in model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], t), k
    for a, b in zip(fresh.optimizer.state_dict()["state"].values(), state.optimizer.state_dict()["state"].values()):
        assert all(torch.equal(a[s], b[s]) for s in b)


def test_cli_refuses_what_it_cannot_do(capsys):
    """Without a card the CLI refuses the default device, and a CRAFT flag
    without ``--model CRAFT``; ``--data-parallel`` is ported: on the CPU,
    which is one device, it trains in this process."""
    from lightly_ocr_tpu_torch.train.trainer import main

    assert main(["--model", "CRAFT", "--device", "cpu", "--data-parallel", "--num-steps", "1",
                 "--batch", "1", "--height", "32", "--width", "32", "--log-every", "0"]) == 0
    out = capsys.readouterr().out
    assert "craft training on device cpu" in out and "data-parallel" not in out
    if not torch.cuda.is_available():  # without --device it asks for the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--model", "CRAFT", "--num-steps", "1"])
    with pytest.raises(SystemExit):  # a CRAFT flag without --model CRAFT
        main(["--num-steps", "1"])
