"""Seam tail of the PyTorch port (``ops/seam_tail.py``) vs the JAX package.

The plain version is held against the Pallas seam kernel in interpret mode
(bf16, at a geometry where ``_pick_rows_seam`` engages) and against the
full float32 detector head.  Kernel #3's plain version (``tail_scores``) is
held against the Pallas ``_tail_kernel`` through the concat-fed
``fused_tail_scores_cs`` and through the legacy branch of
``fused_tail_scores_cs_seam``.  The CUDA kernels are held against the plain
versions in ``test_torch_kernels_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_ocr_tpu.models.vgg_unet import VGG_UNet as JVGG_UNet
from lightly_ocr_tpu.models.vgg_unet import VGG_UNetTrunk as JTrunk
from lightly_ocr_tpu.ops import pallas_tail as pt
from lightly_ocr_tpu.ops.pallas_tail import _pick_rows_seam, fused_tail_scores_cs_seam as jseam
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.ops import seam_tail as st
from lightly_ocr_tpu_torch.weights import state_dict_from_variables

from test_torch_detector import perturbed_detector_vars


@pytest.fixture(scope="module")
def setup():
    v = perturbed_detector_vars(seed=3)
    net = VGG_UNet()
    net.load_state_dict(state_dict_from_variables(v), strict=True)
    x = np.random.default_rng(11).standard_normal((2, 96, 64, 3)).astype(np.float32)
    return v, net.eval(), x


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def test_plain_matches_pallas_seam_kernel_bf16(setup):
    v, net, x = setup
    y_lo, t = JTrunk(dtype=jnp.bfloat16, seam=True).apply(v, jnp.asarray(x))
    assert _pick_rows_seam(t.shape[1], t.shape[2]) == 24  # the seam kernel runs
    ref = np.asarray(jseam(v, y_lo, t, interpret=True), np.float32)  # [B, H2, 2, W2]
    p = st.tail_params(net, torch.bfloat16)
    with torch.no_grad():
        got = st.fused_tail_scores_cs_seam(p, _bf16(y_lo), _bf16(t)).numpy()
    assert got.shape == ref.shape == (2, 48, 2, 32)
    # same bf16 cast points; only the f32 summation order differs, which
    # can flip the bf16 rounding of an intermediate: most scores are
    # bit-identical, the rest are bounded relative to the scores
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-2 * scale
    assert np.mean(got == ref) > 0.9


def test_plain_f32_equals_full_detector_head(setup):
    """In float32 the plain tail on the seam pair is the detector's own
    upconv4 + conv_cls (no rounding anywhere)."""
    v, net, x = setup
    ref, _ = JVGG_UNet().apply(v, jnp.asarray(x))
    ref = np.moveaxis(np.asarray(ref), 3, 2)  # channels-second
    p = st.tail_params(net, torch.float32)
    with torch.no_grad():
        y_lo, t = net.trunk(torch.from_numpy(x))
        got = st.fused_tail_scores_cs_seam(p, y_lo, t).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_wrapper_takes_plain_version_on_cpu(setup):
    _, net, _ = setup
    p = st.tail_params(net, torch.bfloat16)
    rng = np.random.default_rng(0)
    ya = torch.from_numpy(rng.standard_normal((1, 4, 6, 64)).astype(np.float32))
    t = _bf16(rng.standard_normal((1, 8, 12, 128)))
    before = st.seam_tail.launches
    out = st.seam_tail(ya, t, p)
    assert st.seam_tail.launches == before  # no kernel launched
    torch.testing.assert_close(out, st.seam_tail_plain(ya, t, p), rtol=0, atol=0)


def _tail_gate(got, ref):
    """The seam tail's gate: at least 90% of the scores bit-identical, max
    |diff| within 1% of the largest score (bf16 rounds at the same points;
    the float32 sums run in another order)."""
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-2 * scale
    assert np.mean(got == ref) >= 0.9


def test_concat_tail_matches_pallas_tail_kernel(setup):
    """``fused_tail_scores_cs`` (the K=192 1x1 as a float32 matmul, then
    kernel #3's plain version) vs the JAX ``fused_tail_scores_cs`` on the
    concat trunk's 192-channel activation, bf16, ``_tail_kernel``
    interpreted; the JAX output compared on its first W/2 columns.  Also the
    channels-last ``fused_tail_scores`` against its JAX counterpart."""
    v, net, x = setup
    y192 = JTrunk(dtype=jnp.bfloat16).apply(v, jnp.asarray(x))
    ref = np.asarray(pt.fused_tail_scores_cs(v, y192, interpret=True), np.float32)[..., :32]
    p = st.tail_params(net, torch.bfloat16)
    before = st.tail_scores.launches
    with torch.no_grad():
        got = st.fused_tail_scores_cs(p, _bf16(y192)).numpy()
        last = st.fused_tail_scores(p, _bf16(y192)).numpy()
    assert st.tail_scores.launches == before  # a CPU tensor takes the plain version
    assert got.shape == (2, 48, 2, 32)
    _tail_gate(got, ref)
    assert last.shape == (2, 48, 32, 2)
    np.testing.assert_array_equal(last, np.moveaxis(got, 2, 3))
    ref_last = np.asarray(pt.fused_tail_scores(v, y192, interpret=True), np.float32)
    _tail_gate(last, ref_last)


def test_legacy_branch_equals_seam_path_f32(setup, monkeypatch):
    """``LIGHTLY_OCR_TAIL_SEAMK=0`` (read at call time) takes the legacy
    branch: ``x`` formed in PyTorch, then kernel #3.  In float32 on the CPU
    it is the seam path's own arithmetic, bit for bit."""
    _, net, x = setup
    p = st.tail_params(net, torch.float32)
    with torch.no_grad():
        y_lo, t = net.trunk(torch.from_numpy(x))
        seam = st.fused_tail_scores_cs_seam(p, y_lo, t).numpy()
        monkeypatch.setenv("LIGHTLY_OCR_TAIL_SEAMK", "0")
        legacy = st.fused_tail_scores_cs_seam(p, y_lo, t).numpy()
    np.testing.assert_array_equal(legacy, seam)


@pytest.mark.parametrize("why", ["switch", "geometry"])
def test_legacy_branch_matches_jax_legacy_branch(setup, monkeypatch, why):
    """The legacy branch vs the JAX package's, bf16, ``_tail_kernel``
    interpreted, by the seam tail's gate.  It is taken when the switch is
    0 or when ``y_lo`` is not half the resolution of ``t`` (here 16x12
    against 48x32: the quarter-resolution product is resized to ``t``).
    The JAX package reads the switch when it traces, so its cache is
    cleared before and after."""
    v, net, x = setup
    y_lo, t = JTrunk(dtype=jnp.bfloat16, seam=True).apply(v, jnp.asarray(x))
    if why == "switch":
        monkeypatch.setenv("LIGHTLY_OCR_TAIL_SEAMK", "0")
    else:
        y_lo = jax.image.resize(y_lo, (2, 16, 12, 64), "bilinear")
    jseam.clear_cache()
    try:
        ref = np.asarray(jseam(v, y_lo, t, interpret=True), np.float32)
    finally:
        jseam.clear_cache()
    p = st.tail_params(net, torch.bfloat16)
    calls = []
    monkeypatch.setattr(st, "seam_tail", lambda *a: calls.append(a))
    with torch.no_grad():
        got = st.fused_tail_scores_cs_seam(p, _bf16(y_lo), _bf16(t)).numpy()
    assert calls == []  # the seam kernel's wrapper is not called
    assert got.shape == (2, 48, 2, 32)
    _tail_gate(got, ref)


def test_tail_wrapper_takes_plain_version_on_cpu(setup):
    _, net, _ = setup
    p = st.tail_params(net, torch.bfloat16)
    x = _bf16(np.random.default_rng(1).standard_normal((1, 8, 12, 64)))
    before = st.tail_scores.launches
    out = st.tail_scores(x, p)
    assert st.tail_scores.launches == before
    assert out.shape == (1, 8, 2, 12)
    torch.testing.assert_close(out, st.tail_scores_plain(x, p), rtol=0, atol=0)
