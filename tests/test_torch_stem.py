"""The fused conv1_2 + pool front of the PyTorch port (``ops/stem.py``) vs the
JAX package's Pallas kernels (``ops/pallas_stem.py``, interpret mode).

Covers the plain versions of kernels #4 (the full-resolution conv1_2), #5,
#6 and #7, the block scales of #7's requant (two row blocks and their halo
rows at H = 64), the serving plan that ``Config.fused_stages``/``quant_int8``
select in ``BatchedOCR``, the ``stem`` and int8 ``cpool2`` detectors against
the JAX accelerator plans composed by hand, and the served plans on the
committed demo CRAFT checkpoint.  The CUDA kernels are held against these
plain versions in ``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lightly_ocr_tpu.models.vgg_unet import VGG_UNet as JVGG_UNet
from lightly_ocr_tpu.models.vgg_unet import VGG_UNetTrunk as JTrunk
from lightly_ocr_tpu.models.vgg_unet import VggStemPrefix
from lightly_ocr_tpu.ops import pallas_stem as ps
from lightly_ocr_tpu.ops.pallas_tail import fused_tail_scores_cs_seam as jseam
from lightly_ocr_tpu.ops.s2d_stem import s2d_conv12_pool
from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.layers import init_module, int8_conv, int8_scale, quantize_with
from lightly_ocr_tpu_torch.models.vgg_unet import _VGG_SLICES, VGG_UNet
from lightly_ocr_tpu_torch.ops import stem
from lightly_ocr_tpu_torch.serving import batch
from lightly_ocr_tpu_torch.serving.batch import BatchedOCR
from lightly_ocr_tpu_torch.weights import state_dict_from_variables

from test_torch_detector import perturbed_detector_vars

KERNELS = {
    "stem_conv": (ps.fused_stem_conv, stem.fused_stem_conv),
    "conv12_pool": (ps.fused_conv12_pool, stem.fused_conv12_pool),
    "conv12_pool_conv21": (ps.fused_conv12_pool_conv21, stem.fused_conv12_pool_conv21),
    "conv12_pool_conv21_q": (ps.fused_conv12_pool_conv21_q, stem.fused_conv12_pool_conv21_q),
}


@pytest.fixture(scope="module")
def setup():
    v = perturbed_detector_vars(seed=5)
    net = VGG_UNet()
    net.load_state_dict(state_dict_from_variables(v), strict=True)
    return v, net.eval(), stem.stem_params(net)


def _x0(v, shape, seed):
    """The conv1_1 activation of a seeded canvas, from the JAX prefix in
    bf16 (the kernels' input in serving)."""
    x = np.random.default_rng(seed).standard_normal((*shape, 3)).astype(np.float32)
    x0 = VggStemPrefix(dtype=jnp.bfloat16).apply(v, jnp.asarray(x))
    return x0, torch.from_numpy(np.asarray(x0, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(2, 64, 48), (1, 32, 32)], ids=["two_blocks", "one_block"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_plain_matches_pallas_kernel(setup, kernel, shape):
    """#4/#5/#6: same bf16 operands, float32 sums in another order, so a bf16
    rounding falls the other way now and then: at least 99% bit-identical,
    max |diff| within one bf16 step of the largest output.  #7: int8
    products and int32 sums are exact and the dequant/requant round as the
    interpreted kernel does (one FMA, reciprocal of s2): at least 99.9%
    bit-identical, max |diff| within 1% of the largest output."""
    v, _, p = setup
    jf, tf = KERNELS[kernel]
    x0, x0t = _x0(v, shape, seed=1)
    assert stem.conv_pool_supported(*shape[1:]) and stem.stem_supported(shape[1])
    ref = np.asarray(jf(v, x0, interpret=True), np.float32)
    before = tf.launches
    got = tf(x0t, p)
    assert tf.launches == before  # a CPU tensor takes the plain version
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    d = np.abs(got - ref).max()
    if kernel.endswith("_q"):
        assert np.mean(got == ref) >= 0.999
        assert d <= 1e-2 * scale
    else:
        assert np.mean(got == ref) >= 0.99
        assert d <= 2.0 ** (np.floor(np.log2(scale)) - 7)


def test_requant_scales_are_blockwise_with_halo():
    """H = 64 gives rows = 32: two blocks of 16 pooled rows.  Each block's
    s2 is the amax over its rows and one row on each side (clipped), and a
    halo row is quantized with the reading block's s2."""
    assert stem._pick_rows_even(64) == 32
    rng = np.random.default_rng(2)
    pooled = torch.from_numpy(np.abs(rng.standard_normal((2, 32, 24, 64))).astype(np.float32))
    pooled[1, 16] *= 40.0  # block 1's first row dominates block 0 through the halo
    win, s2 = stem.requant_windows(pooled, 32)
    assert win.shape == (2, 2, 18, 24, 64) and s2.shape == (2, 2)
    for b in range(2):
        for i, (lo, hi) in enumerate(((0, 17), (15, 32))):
            want = pooled[b, lo:hi].abs().max().clamp_min(1e-12) / 127.0
            assert s2[b, i] == want
    assert s2[1, 0] == s2[1, 1]  # the large row sets both blocks' scale
    assert torch.equal(win[:, 0, 0], torch.zeros_like(win[:, 0, 0]))  # ring above row 0
    assert torch.equal(win[:, 1, 0], pooled[:, 15])  # block 1 reads block 0's last row
    assert torch.equal(win[:, 0, 17], pooled[:, 16])


def test_int8_kernel_close_to_float_chain(setup):
    """#7 against the float conv1_2 + pool + conv2_1 chain, by the JAX
    package's own gate (``tests/test_pallas_stem.py``): correlation above
    0.999 and max |diff| within 5% of the largest value."""
    v, net, p = setup
    _, x0t = _x0(v, (2, 64, 48), seed=8)
    got = stem.fused_conv12_pool_conv21_q(x0t, p).float()
    with torch.no_grad():
        s1 = net.basenet.slice1
        x = x0t.float().permute(0, 3, 1, 2)
        ref = s1(x, _VGG_SLICES["slice1"][2:7]).permute(0, 2, 3, 1)  # conv1_2 .. conv2_1 + ReLU
    cc = np.corrcoef(ref.numpy().ravel(), got.numpy().ravel())[0, 1]
    assert cc > 0.999
    assert (ref - got).abs().max() <= 0.05 * ref.abs().max()


_CFG = dict(prediction="Attention", transform="TPS", output_channel=64, hidden_size=32,
            character="abcdefghij", batch_max_len=8, canvas_size=128, bucket_granularity=32)


@pytest.fixture(scope="module")
def states():
    g = torch.Generator().manual_seed(0)
    return (init_module(VGG_UNet(), g).state_dict(),
            init_module(CRNNet(Config(**_CFG)), g).state_dict())


FRONTS = ("fused_stem_conv", "fused_conv12_pool", "fused_conv12_pool_conv21",
          "fused_conv12_pool_conv21_q", "conv12_pool_plain")


def _record_fronts(monkeypatch, called):
    for name in FRONTS:
        fn = getattr(stem, name)
        monkeypatch.setattr(batch, name, lambda x0, p, fn=fn, name=name: (called.append(name), fn(x0, p))[1])


def _plan(stages, quant, want, width=96, dtype=torch.float32):
    """A case of ``test_plan_follows_config``; the 64x96 float32 cases keep
    the ids they had before the canvas and dtype were parameters."""
    tag = "" if (width, dtype) == (96, torch.float32) else f"-w{width}-{str(dtype).split('.')[1]}"
    return pytest.param(stages, quant, want, width, dtype, id=f"{stages}-{quant}-{want}{tag}")


@pytest.mark.parametrize("stages,quant,want,width,dtype", [
    _plan("tail,stem", False, "fused_stem_conv"),
    _plan("tail,stem,cpool,cpool2,s2d", False, "fused_stem_conv"),  # stem wins
    _plan("tail,stem,cpool2", True, "fused_conv12_pool_conv21_q"),  # int8 drops stem
    _plan("tail,stem", True, None),
    _plan("tail,cpool2", True, "fused_conv12_pool_conv21_q"),
    _plan("tail,cpool2", False, "fused_conv12_pool_conv21"),
    _plan("tail,cpool", True, "fused_conv12_pool"),
    _plan("tail,cpool,cpool2", False, "fused_conv12_pool_conv21"),
    _plan("tail,s2d", True, None),
    _plan("cpool2", True, None),  # no tail: the plain detector
    # bf16 s2d takes every even canvas, as the JAX package's s2d stem does:
    # kernel #5 where it takes the width, else the same fold in stock ops
    _plan("tail,s2d", False, "fused_conv12_pool", 96, torch.bfloat16),
    _plan("tail,s2d", False, "conv12_pool_plain", 72, torch.bfloat16),
    _plan("tail,cpool", False, None, 72, torch.bfloat16),  # kernel plans: plain slice1
])
def test_plan_follows_config(states, monkeypatch, stages, quant, want, width, dtype):
    """``fused_stages`` and ``quant_int8`` pick the kernel as the JAX
    ``_fused_kernel_plan`` does; plans without one run no stem kernel."""
    called = []
    _record_fronts(monkeypatch, called)
    ocr = BatchedOCR(Config(**_CFG, fused_stages=stages, quant_int8=quant), *states,
                     boxes_per_image=4, dtype=dtype, device="cpu")
    assert ocr.det_net.basenet.slice2["17"].quantized == quant
    assert stem.s2d_supported(64, width) and stem.conv_pool_supported(64, width) == (width % 16 == 0)
    canv = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 64, width, 3)).astype(np.float32))
    with torch.no_grad():
        tm, lm = ocr.detector_scores(canv)
    assert tm.shape == lm.shape == (1, 32, width // 2) and tm.dtype == torch.float32
    assert called == ([want] if want else [])


def test_unsupported_canvas_runs_plain_slice1(states, monkeypatch):
    """A canvas width that is not a multiple of 16 takes the plain slice1,
    as the JAX plan does."""
    def refuse(x0, p):
        raise AssertionError("the kernel cannot take this canvas")

    monkeypatch.setattr(batch, "fused_conv12_pool_conv21_q", refuse)
    ocr = BatchedOCR(Config(**_CFG, fused_stages="tail,cpool2", quant_int8=True), *states,
                     boxes_per_image=4, dtype=torch.float32, device="cpu")
    assert not stem.conv_pool_supported(64, 40)
    with torch.no_grad():
        tm, _ = ocr.detector_scores(torch.zeros(1, 64, 40, 3))
    assert tm.shape == (1, 32, 20)


@pytest.mark.parametrize("stages", ["tail,stem", "tail,stem,cpool2"])
def test_stem_plan_raises(states, monkeypatch, caplog, stages):
    """Kernel #4 is ported: a ``stem`` plan no longer raises.  In bf16 it
    runs ``fused_stem_conv`` and the trunk resumed at pool1; under int8 the
    JAX plan never runs the stem, so it is dropped with a warning and the
    plan goes on to ``cpool2`` where asked."""
    called = []
    _record_fronts(monkeypatch, called)
    canv = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 64, 96, 3)).astype(np.float32))
    ocr = BatchedOCR(Config(**_CFG, fused_stages=stages), *states, boxes_per_image=4,
                     dtype=torch.bfloat16, device="cpu")
    assert (ocr.front, ocr.resume) == (batch.fused_stem_conv, "stem")
    with torch.no_grad():
        tm, _ = ocr.detector_scores(canv)
    assert called == ["fused_stem_conv"] and tm.shape == (1, 32, 48)
    with caplog.at_level(logging.WARNING, logger=batch.__name__):
        ocr = BatchedOCR(Config(**_CFG, fused_stages=stages, quant_int8=True), *states,
                         boxes_per_image=4, dtype=torch.bfloat16, device="cpu")
    assert "fused stem requested but not active" in caplog.text
    called.clear()
    with torch.no_grad():
        ocr.detector_scores(canv)
    assert called == (["fused_conv12_pool_conv21_q"] if "cpool2" in stages else [])


def test_stem_plan_needs_a_supported_height(states, monkeypatch):
    """A canvas height that is not a multiple of 4 has no row split for the
    JAX kernel: the plan runs the plain slice1, as the JAX plan does."""
    called = []
    _record_fronts(monkeypatch, called)
    ocr = BatchedOCR(Config(**_CFG, fused_stages="tail,stem"), *states, boxes_per_image=4,
                     dtype=torch.float32, device="cpu")
    assert not stem.stem_supported(66)
    with torch.no_grad():
        tm, _ = ocr.detector_scores(torch.zeros(1, 66, 64, 3))
    assert called == [] and tm.shape == (1, 33, 32)


def test_s2d_plan_in_bf16_rounds_as_the_jax_s2d_stem(states, monkeypatch):
    """bf16 ``tail,s2d`` (the default plan) runs conv1_1 with BN folded
    (``s2d_prefix``) and kernel #5, the roundings of the JAX package's
    ``s2d_conv12_pool``; in float32 the plain slice1 runs."""
    called = []
    _record_fronts(monkeypatch, called)
    canv = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 64, 96, 3)).astype(np.float32))
    for dtype, want in ((torch.bfloat16, ["fused_conv12_pool"]), (torch.float32, [])):
        called.clear()
        ocr = BatchedOCR(Config(**_CFG), *states, boxes_per_image=4, dtype=dtype, device="cpu")
        with torch.no_grad():
            ocr.detector_scores(canv)
        assert called == want


def test_s2d_prefix_and_kernel5_match_jax_s2d_stem():
    """``s2d_prefix`` then kernel #5's plain version vs the JAX package's
    ``s2d_conv12_pool`` in bf16: the same roundings, float32 sums in another
    order (at least 99% bit-identical, within one bf16 step of the largest
    output)."""
    v = perturbed_detector_vars(seed=9)
    net = VGG_UNet()
    net.load_state_dict(state_dict_from_variables(v), strict=True)
    p = stem.stem_params(net)
    x = np.random.default_rng(9).standard_normal((2, 64, 48, 3)).astype(np.float32)
    ref = np.asarray(s2d_conv12_pool(v, jnp.asarray(x, jnp.bfloat16)), np.float32)
    with torch.no_grad():
        got = stem.fused_conv12_pool(stem.s2d_prefix(torch.from_numpy(x), p), p).float().numpy()
    assert got.shape == ref.shape == (2, 32, 24, 64)
    scale = np.abs(ref).max()
    assert np.mean(got == ref) >= 0.99
    assert np.abs(got - ref).max() <= 2.0 ** (np.floor(np.log2(scale)) - 7)


def test_stem_detector_matches_jax_plan():
    """``detector_scores`` under ``fused_stages="tail,stem"`` in bf16 vs the
    JAX accelerator plan composed by hand: VggStemPrefix -> fused_stem_conv
    -> VGG_UNetTrunk(from_stem, seam) -> fused_tail_scores_cs_seam, both
    kernels interpreted.  The bf16 gate of the JAX package's tests: score
    max |diff| below 0.02.  With random weights the thresholds (quantiles
    of the JAX maps) sit in the bulk of the scores, where any bf16 rounding
    flips a few foreground pixels: no more may flip than between the JAX
    package's own plain bf16 detector and this plan (measured: 14 against
    16 of 3072).  The demo checkpoint case below, whose learned maps are
    bimodal, demands identical boxes."""
    v = perturbed_detector_vars(seed=7)
    x = np.random.default_rng(7).standard_normal((2, 64, 96, 3)).astype(np.float32)
    x0 = VggStemPrefix(dtype=jnp.bfloat16).apply(v, jnp.asarray(x))
    s1c = ps.fused_stem_conv(v, x0, interpret=True)
    y_lo, t = JTrunk(dtype=jnp.bfloat16, from_stem=True, seam=True).apply(v, s1c)
    ref = np.asarray(jseam(v, y_lo, t, interpret=True), np.float32)[:, :, :, :48]

    cfg = Config(**_CFG, fused_stages="tail,stem")
    rec = init_module(CRNNet(cfg), torch.Generator().manual_seed(0)).state_dict()
    ocr = BatchedOCR(cfg, state_dict_from_variables(v), rec, boxes_per_image=4,
                     dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        tm, lm = ocr.detector_scores(torch.from_numpy(x))
    got = torch.stack([tm, lm], 2).numpy()
    assert got.shape == ref.shape == (2, 32, 2, 48)
    assert np.abs(got - ref).max() < 0.02
    full, _ = JVGG_UNet(dtype=jnp.bfloat16).apply(v, jnp.asarray(x))
    full = np.moveaxis(np.asarray(full, np.float32), 3, 2)
    low, link = np.quantile(ref[:, :, 0], 0.8), np.quantile(ref[:, :, 1], 0.97)

    def fg(a):
        return (a[:, :, 0] > low) | (a[:, :, 1] > link)

    assert (fg(got) != fg(ref)).sum() <= (fg(full) != fg(ref)).sum()


def test_int8_cpool2_detector_matches_jax_plan():
    """``detector_scores`` under ``Config(quant_int8=True,
    fused_stages="tail,cpool2")`` in bf16 vs the JAX accelerator plan
    composed by hand (``tests/test_pallas_stem.py``): VggStemPrefix ->
    fused_conv12_pool_conv21_q -> VGG_UNetTrunk(from_c21, seam, quant) ->
    fused_tail_scores_cs_seam, both kernels interpreted.

    bf16 rounds at other points on the two sides, and int8 codes flip with
    it, so the gate is the JAX package's own int8 score gate (max |diff|
    below 0.02, ``tests/test_quant.py``) and 1.5x the spread the JAX
    package itself shows between this plan and its plain bf16 detector on
    the same input (measured: 0.0059 for the port against 0.0063 for the
    JAX package, with scores up to 0.19; the sums' order may change with
    the thread count).  One percent of the largest score would be 0.0019:
    below the JAX package's own spread, so not a gate that holds here."""
    v = perturbed_detector_vars(seed=6)
    x = np.random.default_rng(6).standard_normal((2, 64, 96, 3)).astype(np.float32)
    xj = jnp.asarray(x)
    x0 = VggStemPrefix(dtype=jnp.bfloat16).apply(v, xj)
    p1 = ps.fused_conv12_pool_conv21_q(v, x0, interpret=True)
    y_lo, t = JTrunk(dtype=jnp.bfloat16, from_c21=True, seam=True, quant=True).apply(v, p1)
    ref = np.asarray(jseam(v, y_lo, t, interpret=True), np.float32)[:, :, :, :48]
    full, _ = JVGG_UNet(dtype=jnp.bfloat16).apply(v, xj)
    spread = np.abs(ref - np.moveaxis(np.asarray(full, np.float32), 3, 2)).max()

    cfg = Config(**_CFG, fused_stages="tail,cpool2", quant_int8=True)
    g = torch.Generator().manual_seed(0)
    rec = init_module(CRNNet(cfg), g).state_dict()
    ocr = BatchedOCR(cfg, state_dict_from_variables(v), rec, boxes_per_image=4,
                     dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        tm, lm = ocr.detector_scores(torch.from_numpy(x))
    got = torch.stack([tm, lm], 2).numpy()
    assert got.shape == ref.shape == (2, 32, 2, 48)
    d = np.abs(got - ref).max()
    assert d < 0.02
    assert d <= 1.5 * spread


@pytest.fixture(scope="module")
def demo_setup():
    """The committed demo CRAFT checkpoint (``save_models/demo_craft_bf16``,
    restored as ``tests/test_e2e_parity.py`` does), one synthetic receipt at
    its 320x256 training geometry, and the canvas the port prepares."""
    from test_e2e_parity import _demo_craft_vars

    from lightly_ocr_tpu.data.generator import synthesize_receipt

    v = _demo_craft_vars()
    image, _ = synthesize_receipt(np.random.default_rng(31), 320, 256)
    cfg = Config(**{**_CFG, "canvas_size": 1280}, magnify_ratio=1.0)
    rec = init_module(CRNNet(cfg), torch.Generator().manual_seed(0)).state_dict()
    probe = BatchedOCR(cfg, state_dict_from_variables(v), rec, dtype=torch.float32, device="cpu")
    (cb, gb), _ = next(iter(probe.group([image]).items()))
    assert cb == (320, 256)
    canv = probe.prepare([image], cb, gb)[0]
    return v, cfg, rec, canv


def _jax_plan(v, plan, x):
    """The JAX accelerator plan composed by hand (``BatchedOCR._build``),
    kernels interpreted: channels-second scores [B, H2, 2, W2]."""
    xj = jnp.asarray(x)
    if plan == "default":
        p1 = s2d_conv12_pool(v, xj.astype(jnp.bfloat16))
        y_lo, t = JTrunk(dtype=jnp.bfloat16, from_pool=True, seam=True).apply(v, p1)
    else:
        x0 = VggStemPrefix(dtype=jnp.bfloat16).apply(v, xj)
        if plan == "stem":
            s1c = ps.fused_stem_conv(v, x0, interpret=True)
            y_lo, t = JTrunk(dtype=jnp.bfloat16, from_stem=True, seam=True).apply(v, s1c)
        else:
            p1 = ps.fused_conv12_pool_conv21_q(v, x0, interpret=True)
            y_lo, t = JTrunk(dtype=jnp.bfloat16, from_c21=True, seam=True, quant=True).apply(v, p1)
    return np.asarray(jseam(v, y_lo, t, interpret=True), np.float32)


def _boxes(cfg, scores):
    """The JAX package's box extraction of channels-second scores of one
    image at the config's thresholds: (boxes [K, 4, 2], valid [K])."""
    from lightly_ocr_tpu.ops.detection import get_det_boxes

    d = get_det_boxes(jnp.asarray(scores[0, :, 0]), jnp.asarray(scores[0, :, 1]),
                      text_threshold=cfg.text_threshold, link_threshold=cfg.link_threshold,
                      low_text=cfg.low_text, max_boxes=64)
    return np.asarray(d.boxes), np.asarray(d.valid)


@pytest.mark.parametrize("plan", ["default", "stem", "int8_cpool2"])
def test_demo_checkpoint_plan_matches_jax(demo_setup, plan):
    """The served plans on the demo checkpoint's learned (bimodal) score
    maps, at the reference thresholds (0.4 / 0.7), vs the JAX plans
    composed by hand: the port's default plan (bf16 ``tail,s2d``), bf16
    ``tail,stem`` and int8 ``tail,cpool2``.  Every plan: identical boxes.
    bf16 plans: max |diff| within 1% of the largest score.

    int8: XLA computes the BN fold's ``scale / sqrt(var + eps)`` with its
    own rsqrt, which rounds a third of the channels' quotients differently
    from any float32 or float64 formula (none reproduces it); a flipped
    quotient can move a channel's int8 weight scale, and the per-sample
    int8 scales downstream spread that to a few pixels.  Here 99% of the
    scores stay within 1% of the largest and all within 5% (measured: 0.56%
    and 4.6%; a float64 quotient reads 0.93% here but moves kernel #7 off
    the JAX kernel on the random weights above)."""
    v, cfg, rec, canv = demo_setup
    stages = {"default": "tail,s2d", "stem": "tail,stem", "int8_cpool2": "tail,cpool2"}[plan]
    c = cfg.replace(fused_stages=stages, quant_int8=plan == "int8_cpool2")
    ocr = BatchedOCR(c, state_dict_from_variables(v), rec, dtype=torch.bfloat16, device="cpu")
    ref = _jax_plan(v, plan, canv.numpy())
    with torch.no_grad():
        tm, lm = ocr.detector_scores(canv)
    got = torch.stack([tm, lm], 2).numpy()
    assert got.shape == ref.shape == (1, 160, 2, 128)
    scale = np.abs(ref).max()
    assert scale > 0.9  # a learned map: text scores near 1
    d = np.abs(got - ref)
    if plan == "int8_cpool2":
        assert np.quantile(d, 0.99) <= 0.01 * scale
        assert d.max() <= 0.05 * scale
    else:
        assert d.max() <= 0.01 * scale
    bj, vj = _boxes(c, ref)
    bt, vt = _boxes(c, got)
    assert vj.sum() >= 6
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(bt, bj)


def test_demo_checkpoint_s2d_plan_at_unsupported_width(demo_setup, monkeypatch):
    """The default plan (bf16 ``tail,s2d``) on a canvas whose width is 8 mod
    16, which kernel #5 does not take, on the demo checkpoint's learned maps
    (a 64x72 window of the receipt canvas around two words): the front is
    ``s2d_prefix`` and then the folded conv1_2 + pool in stock ops, which
    rounds as the JAX package's ``s2d_conv12_pool`` does (at least 99%
    bit-identical, within one bf16 step of the largest output); the scores
    meet the bf16 gate against the JAX package's bf16 detector (max |diff|
    below 0.02) with identical boxes."""
    v, cfg, rec, canv = demo_setup
    canvas = canv[:, 180:244, 16:88].contiguous()
    assert stem.s2d_supported(64, 72) and not stem.conv_pool_supported(64, 72)
    called = []
    _record_fronts(monkeypatch, called)
    ocr = BatchedOCR(cfg, state_dict_from_variables(v), rec, dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        tm, lm = ocr.detector_scores(canvas)
        front = ocr.front_for(64, 72)(ocr.prefix(canvas), ocr.stem).float().numpy()
    assert called == ["conv12_pool_plain"] * 2
    ref_front = np.asarray(s2d_conv12_pool(v, jnp.asarray(canvas.numpy(), jnp.bfloat16)), np.float32)
    assert front.shape == ref_front.shape == (1, 32, 36, 64)
    assert np.mean(front == ref_front) >= 0.99
    assert np.abs(front - ref_front).max() <= 2.0 ** (np.floor(np.log2(np.abs(ref_front).max())) - 7)
    got = torch.stack([tm, lm], 2).numpy()
    ys, _ = jax.jit(JVGG_UNet(dtype=jnp.bfloat16).apply)(v, jnp.asarray(canvas.numpy()))
    ref = np.moveaxis(np.asarray(ys, np.float32), 3, 2)
    assert got.shape == ref.shape == (1, 32, 2, 36)
    assert np.abs(ref).max() > 0.9
    assert np.abs(got - ref).max() < 0.02
    bj, vj = _boxes(cfg, ref)
    bt, vt = _boxes(cfg, got)
    assert vj.sum() >= 2
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(bt, bj)


# -- conv3x3_hopper's cut of the map, replayed in PyTorch ---------------------
# Integer-valued operands keep every float32 sum exact whatever its order, so
# the stitched blocks must equal the whole-map plain versions bit for bit.


def _int_stem_params(seed: int) -> stem.StemParams:
    rng = np.random.default_rng(seed)

    def w(cout):  # {-1, 0, 1}, tap-major [576, cout]
        return torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], size=(576, cout), p=[0.2, 0.6, 0.2])
                                .astype(np.float32)).to(torch.bfloat16)

    def b(n):  # positive biases make relu(bias) != 0 where the input is zero
        return torch.from_numpy(rng.integers(-2, 4, n).astype(np.float32))

    none = torch.zeros(0)
    return stem.StemParams(w0=none, b0=none, w1=w(64), b1=b(64), w2=w(128), b2=b(128),
                           q1=none, sw1=none, q2=none, sw2=none)


def _window(a, r0, r1, c0, c1):
    """``a`` [H, W, C] cut to rows [r0, r1), cols [c0, c1), zeros outside."""
    H, W, C = a.shape
    out = a.new_zeros((r1 - r0, c1 - c0, C))
    rr0, rr1, cc0, cc1 = max(r0, 0), min(r1, H), max(c0, 0), min(c1, W)
    if rr0 < rr1 and cc0 < cc1:
        out[rr0 - r0:rr1 - r0, cc0 - c0:cc1 - c0] = a[rr0:rr1, cc0:cc1]
    return out


def _replay_conv(x, wk, bk, pool):
    """One launch of ``conv3x3_hopper`` stitched from its blocks: each block
    (sample, strip, segment) takes its input rows and columns with HALO more
    on every side, zeros outside the image, and computes two conv rows a
    step (a segment of odd length computes one row past the image) as a
    VALID 3x3 conv, + bias, ReLU; with ``pool`` the 2x2 max pairs conv
    columns (2g, 2g + 1) of the step's two rows.  The block keeps what lies
    inside the image.  ``x`` [B, H, W, 64] float32 -> bf16."""
    cout = wk.shape[1]
    strip, seg, halo = stem.STRIP_COLS[cout], stem.SEGMENT_ROWS[cout], stem.HALO
    B, H, W, _ = x.shape
    k = stem._oihw(wk)
    out = torch.full((B, H // 2, W // 2, cout) if pool else (B, H, W, cout), float("nan"))
    for b in range(B):
        for c0 in range(0, W, strip):
            for s0 in range(0, H, seg):
                s1 = min(s0 + seg, H)
                rows = s1 - s0 + (s1 - s0) % 2
                win = _window(x[b], s0 - halo, s0 + rows + halo, c0 - halo, c0 + strip + halo)
                y = F.relu(F.conv2d(win.permute(2, 0, 1)[None], k)[0] + bk[:, None, None])
                if pool:
                    y = y.view(cout, rows // 2, 2, strip // 2, 2).amax(dim=(2, 4))
                    r0, r1, cc0, cc1 = s0 // 2, s1 // 2, c0 // 2, min(c0 + strip, W) // 2
                else:
                    r0, r1, cc0, cc1 = s0, s1, c0, min(c0 + strip, W)
                out[b, r0:r1, cc0:cc1] = y[:, :r1 - r0, :cc1 - cc0].permute(1, 2, 0)
    return out.to(torch.bfloat16)


# the smallest sizes (#4: H % 4 == 0, W % 8 == 0; #6: H even, W % 16 == 0),
# a W past one strip, an H past two segments, and a wide map
_HOPPER_CUT = [("stem_conv", (1, 4, 8)), ("stem_conv", (1, 8, stem.STRIP_COLS[64] + 8)),
               ("stem_conv", (1, 2 * stem.SEGMENT_ROWS[64] + 4, 16)), ("stem_conv", (1, 96, 160)),
               ("conv12_pool_conv21", (1, 2, 16)),
               ("conv12_pool_conv21", (1, 4, stem.STRIP_COLS[64] + 16)),
               ("conv12_pool_conv21", (1, 2 * stem.SEGMENT_ROWS[64] + 4, 16)),
               ("conv12_pool_conv21", (1, 96, 160))]


@pytest.mark.parametrize("kernel,shape", _HOPPER_CUT,
                         ids=[f"{k}-{'x'.join(map(str, s))}" for k, s in _HOPPER_CUT])
def test_hopper_cut_stitches_to_plain(kernel, shape):
    """#4, and #6 as its two launches (conv1_2 + pool, then conv2_1 on the
    bf16 pooled map), replayed block by block, equal the plain versions."""
    B, H, W = shape
    p = _int_stem_params(11)
    rng = np.random.default_rng(H * 1000 + W)
    x0 = torch.from_numpy(rng.integers(0, 4, (B, H, W, 64)).astype(np.float32)).to(torch.bfloat16)
    if kernel == "stem_conv":
        ref = stem.fused_stem_conv_plain(x0, p)
        got = _replay_conv(x0.float(), p.w1, p.b1, pool=False)
    else:
        ref = stem.conv12_pool_conv21_plain(x0, p)
        pooled = _replay_conv(x0.float(), p.w1, p.b1, pool=True)
        assert torch.equal(pooled, stem.conv12_pool_plain(x0, p))
        got = _replay_conv(pooled.float(), p.w2, p.b2, pool=False)
    assert ref.float().abs().max() < 2 ** 20  # integer sums stay exact in float32
    assert ref.unique().numel() > 16  # the signal reaches the output
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def _int8_stem_params(seed: int) -> stem.StemParams:
    """int8 codes in [-3, 3], float32 weight scales and biases (positive
    biases make relu(bias) != 0 where the input is zero).  conv1_2's channel
    0 has only negative codes and a large bias, so on the non-negative
    ``x0`` a pooled column past the image (zeros in, the bias out) would
    top every row's max if it were counted."""
    rng = np.random.default_rng(seed)

    def q(cout):
        return torch.from_numpy(rng.integers(-3, 4, (576, cout)).astype(np.int8))

    def f(n, lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32))

    q1, b1 = q(64), f(64, -0.2, 0.5)
    q1[:, 0], b1[0] = -3, 4.0
    none = torch.zeros(0)
    return stem.StemParams(w0=none, b0=none, w1=none, b1=b1, w2=none, b2=f(128, -0.2, 0.5),
                           q1=q1, sw1=f(64, 2e-3, 8e-3), q2=q(128), sw2=f(128, 2e-3, 8e-3))


def _replay_int8(x0, p):
    """Kernel #7 stitched from its launches' blocks.  The per-sample scale
    and codes of ``x0``; conv1_2 + pool per (sample, strip, segment) on the
    int8 window with its halo (zeros outside the image), each pooled row's
    max taken over the strip's columns inside the image and combined across
    strips (the atomicMax); then conv2_1 per (sample, strip, requant block of
    ``r2`` rows): ``s2`` from the maxima of the block's rows and one halo row
    each side, the block's f32 rows quantized with it, two output rows a
    step (a block of odd ``r2`` computes one row past it, from zero rows),
    the rows of the block kept.  Returns (bf16 output, f32 pooled map, row
    maxima, block scales)."""
    B, H, W, _ = x0.shape
    xf = x0.float()
    sx = stem.scale127(xf.abs().amax(dim=(1, 2, 3), keepdim=True))
    xq = quantize_with(xf, sx)
    halo, strip, seg = stem.HALO, stem.STRIP_COLS[64], stem.S8_SEGMENT_ROWS
    H2, W2 = H // 2, W // 2
    pooled = torch.full((B, H2, W2, 64), float("nan"))
    rowmax = torch.zeros(B, H2)
    for b in range(B):
        for c0 in range(0, W, strip):
            for s0 in range(0, H, seg):
                s1 = min(s0 + seg, H)
                win = _window(xq[b], s0 - halo, s1 + halo, c0 - halo, c0 + strip + halo)
                acc = int8_conv(win[None], p.q1)[0].float()
                y = F.relu(stem._fma(acc, sx[b, 0, 0] * p.sw1, p.b1))
                y = y.view((s1 - s0) // 2, 2, strip // 2, 2, 64).amax(dim=(1, 3))
                cc = min(c0 + strip, W) // 2 - c0 // 2
                pooled[b, s0 // 2:s1 // 2, c0 // 2:c0 // 2 + cc] = y[:, :cc]
                rowmax[b, s0 // 2:s1 // 2] = torch.maximum(rowmax[b, s0 // 2:s1 // 2],
                                                           y[:, :cc].amax(dim=(1, 2)))
    r2, strip = stem._pick_rows_even(H) // 2, stem.STRIP_COLS[128]
    rows = r2 + r2 % 2  # whole steps of two rows
    out = torch.full((B, H2, W2, 128), float("nan"))
    s2 = torch.zeros(B, H2 // r2)
    for b in range(B):
        for i, s0 in enumerate(range(0, H2, r2)):
            s2[b, i] = int8_scale(rowmax[b, max(s0 - 1, 0):s0 + r2 + 1].max())
            for c0 in range(0, W2, strip):
                win = _window(pooled[b], s0 - halo, s0 + rows + halo, c0 - halo, c0 + strip + halo)
                win[r2 + 2:] = 0  # past the block's last halo row: not copied
                qw = torch.clamp(torch.round(win * (torch.ones(()) / s2[b, i])), -127, 127)
                acc = int8_conv(qw.to(torch.int8)[None], p.q2)[0].float()
                y = F.relu(stem._fma(acc, s2[b, i] * p.sw2, p.b2))
                cc = min(c0 + strip, W2) - c0
                out[b, s0:s0 + r2, c0:c0 + cc] = y[:r2, :cc]
    return out.to(torch.bfloat16), pooled, rowmax, s2


# r2 = 1 (H = 66: one pooled row a block, the step's second row past it);
# r2 = 2 with W2 past one conv2_1 strip; two blocks of r2 = 16 across a
# strip edge; three blocks over two strips; H past two conv1_2 segments
_INT8_CUT = [(1, 66, 32), (1, 12, 144), (1, 64, 144), (1, 96, 160),
             (1, 2 * stem.S8_SEGMENT_ROWS + 4, 16)]


@pytest.mark.parametrize("shape", _INT8_CUT, ids=["x".join(map(str, s)) for s in _INT8_CUT])
def test_int8_hopper_cut_stitches_to_plain(shape):
    """#7 replayed block by block (``_replay_int8``) equals its plain
    version bit for bit: the pooled rows' maxima are the rows' amax, each
    block's scale is the plain version's (its rows with a one-row halo),
    and the stitched output is ``conv12_pool_conv21_q_plain``'s."""
    B, H, W = shape
    p = _int8_stem_params(12)
    rng = np.random.default_rng(H * 1000 + W)
    x0 = torch.from_numpy(rng.integers(0, 4, (B, H, W, 64)).astype(np.float32)).to(torch.bfloat16)
    ref = stem.conv12_pool_conv21_q_plain(x0, p)
    got, pooled, rowmax, s2 = _replay_int8(x0, p)
    assert not pooled.isnan().any() and torch.equal(rowmax, pooled.amax(dim=(2, 3)))
    _, want_s2 = stem.requant_windows(pooled, stem._pick_rows_even(H))
    assert torch.equal(s2, want_s2)
    assert ref.unique().numel() > 16  # the signal reaches the output
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_hopper_geometry_fits_shared_memory():
    """A conv3x3_hopper block's weights, bias (int8: and weight scales),
    ring of input rows (int8 conv2_1: and float32 staging rows) fit the
    232,448 B of shared memory an H100 block may have, in bf16 and in int8,
    and two int8 conv1_2 blocks fit an SM;
    segments are whole row pairs (the pool's), strips whole 64-column
    warpgroup tiles, the ring holds the step's 4 input rows and two steps of
    2 in flight, and the staging rows two steps of 2."""
    for cout in (64, 128):
        for s8 in (False, True):
            assert stem.smem_bytes(cout, s8) <= 232448
        assert stem.SEGMENT_ROWS[cout] % 2 == 0 and stem.STRIP_COLS[cout] % 64 == 0
    # two int8 conv1_2 blocks an SM: 228 KB, 1 KB reserved for each block
    assert stem.S8_BLOCKS * (stem.smem_bytes(64, s8=True) + 1024) <= 233472
    assert stem.S8_SEGMENT_ROWS % 2 == 0
    assert stem.RING_ROWS == 4 + 2 * 2 and stem.STAGE_ROWS == 2 * 2 and stem.HALO == 1
    # the note in stem.cu
    assert stem.geometry() == (128, 120, 64, 60, 60, 2, 1, 8, 4, 208128, 216576, 109056, 185344)
