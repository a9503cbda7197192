"""Row-packed convs and the serving plan's switches of the port vs the JAX
package (CPU).

* ``ops/rowpack.py``: the cases of ``tests/test_rowpack.py`` against the JAX
  functions on the same inputs (float32 to 1e-5; the bf16 stem and tail
  against the JAX package's bf16 functions within 2e-2 of the largest
  value, the rounding points being the same but not every sum's order),
  and the composition ``BatchedOCR`` runs under ``fused_impl="rowpack"``
  against the plain bf16 detector (5e-3, the JAX test's bound);
* the plan switches, the cases of ``tests/test_fused_gating.py`` for the
  port's ``BatchedOCR``: ``LIGHTLY_OCR_ENABLE_FUSED`` over
  ``Config.fused_stages``, ``LIGHTLY_OCR_FUSED_IMPL`` over ``fused_impl``
  (rowpack turns ``s2d`` and ``cpool`` off), ``monolith`` /
  ``LIGHTLY_OCR_MONOLITH`` and ``cpool_pool`` / ``LIGHTLY_OCR_CPOOL_POOL``
  (accepted, with no effect: the stage functions are always exposed and
  their composition equals the call, and the one pooling equals the
  reshape formulation), ``LIGHTLY_OCR_ROWPACK_G``, and the warnings on
  explicit requests that
  cannot be honoured.  The port runs its plans on the CPU and on the card
  alike (the kernels' plain versions here), where the JAX package runs its
  fused stages on the TPU only: the default plan resolves to the tail and
  ``s2d`` here.
"""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightly_ocr_tpu.models.vgg_unet import VGG_UNet as JVGG_UNet
from lightly_ocr_tpu.models.vgg_unet import VggStemPrefix as JVggStemPrefix
from lightly_ocr_tpu.ops import rowpack as jrowpack
from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.layers import init_module
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.ops import rowpack, stem
from lightly_ocr_tpu_torch.ops.seam_tail import fused_tail_scores_cs_seam, tail_params
from lightly_ocr_tpu_torch.serving import batch
from lightly_ocr_tpu_torch.serving.batch import BatchedOCR
from lightly_ocr_tpu_torch.weights import state_dict_from_variables

ENVS = ("LIGHTLY_OCR_ENABLE_FUSED", "LIGHTLY_OCR_FUSED_IMPL", "LIGHTLY_OCR_MONOLITH",
        "LIGHTLY_OCR_CPOOL_POOL", "LIGHTLY_OCR_ROWPACK_G")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ENVS:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _direct(x, k):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.float32))


# -- the convs -----------------------------------------------------------------

@pytest.mark.parametrize("G,cin,cout", [(2, 64, 64), (4, 16, 32), (8, 32, 16)])
def test_rowpacked_equals_jax_and_direct(G, cin, cout):
    rng = np.random.default_rng(G)
    x = rng.standard_normal((2, 16, 12, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    got = rowpack.conv3x3_rowpacked(torch.from_numpy(x), torch.from_numpy(k), G).numpy()
    np.testing.assert_allclose(got, np.asarray(jrowpack.conv3x3_rowpacked(x, k, G)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _direct(x, k), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(rowpack.pack_kernel(torch.from_numpy(k), G).numpy(),
                                  np.asarray(jrowpack.pack_kernel(jnp.asarray(k), G)))


@pytest.mark.parametrize("G,cin,cout", [(2, 64, 64), (4, 32, 32), (8, 16, 16)])
def test_depthpacked_equals_jax_and_direct(G, cin, cout):
    rng = np.random.default_rng(G + 10)
    x = rng.standard_normal((2, 16, 12, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    got = rowpack.conv3x3_depthpacked(torch.from_numpy(x), torch.from_numpy(k), G).numpy()
    np.testing.assert_allclose(got, np.asarray(jrowpack.conv3x3_depthpacked(x, k, G)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _direct(x, k), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(rowpack.pack_kernel_depth(torch.from_numpy(k), G).numpy(),
                                  np.asarray(jrowpack.pack_kernel_depth(jnp.asarray(k), G)))


def test_rowpacked_g1_is_direct_and_refusals():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 7, 5, 8)).astype(np.float32)
    k = rng.standard_normal((3, 3, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(rowpack.conv3x3_rowpacked(torch.from_numpy(x), torch.from_numpy(k), 1).numpy(),
                               _direct(x, k), rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        rowpack.conv3x3_rowpacked(torch.from_numpy(x), torch.from_numpy(k), 2)
    with pytest.raises(ValueError, match="3-row"):
        rowpack.pack_kernel(torch.zeros(5, 3, 2, 2), 2)


@pytest.fixture(scope="module")
def detector():
    """JAX-initialised ``VGG_UNet`` weights at 32x24, carried across."""
    x = np.random.default_rng(1).standard_normal((2, 32, 24, 3)).astype(np.float32)
    v = jax.tree.map(np.asarray, jax.jit(JVGG_UNet().init)(jax.random.PRNGKey(1), jnp.asarray(x)))
    net = VGG_UNet()
    net.load_state_dict(state_dict_from_variables(v), strict=True)
    return v, net.eval(), x


def test_stem_rowpacked_matches_jax(detector):
    v, net, x = detector
    x0 = np.asarray(JVggStemPrefix(dtype=jnp.bfloat16).apply(v, jnp.asarray(x)))
    want = np.asarray(jrowpack.stem_conv_rowpacked(v, jnp.asarray(x0)), np.float32)
    got = rowpack.stem_conv_rowpacked(torch.from_numpy(x0.astype(np.float32)).to(torch.bfloat16),
                                      stem.stem_params(net))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_tail_rowpacked_matches_jax(detector, monkeypatch):
    """On a seeded bf16 ``y192``, for the default ``G`` and a forced one."""
    v, net, _ = detector
    y192 = np.random.default_rng(3).standard_normal((1, 16, 12, 192)).astype(np.float32)
    y = jnp.asarray(y192, jnp.bfloat16)
    p = tail_params(net, torch.bfloat16)
    for g in ("", "2"):
        monkeypatch.setenv("LIGHTLY_OCR_ROWPACK_G", g)
        want = np.asarray(jrowpack.tail_scores_rowpacked(v, y))
        got = rowpack.tail_scores_rowpacked(torch.from_numpy(np.asarray(y, np.float32)).to(torch.bfloat16), p)
        assert got.dtype == torch.float32 and got.shape == want.shape == (1, 16, 12, 2)
        assert np.abs(got.numpy() - want).max() <= 2e-2 * np.abs(want).max(), g
    assert rowpack.rowpack_g(32, 16) == 2 and rowpack.rowpack_g(16, 12) == 2
    monkeypatch.delenv("LIGHTLY_OCR_ROWPACK_G")
    assert rowpack.rowpack_g(32, 16) == 4 and rowpack.rowpack_g(16, 16) == 8 and rowpack.rowpack_g(64, 6) == 2


# -- the plan switches ------------------------------------------------------------

_CFG = dict(prediction="CTC", transform="None", max_boxes=2, output_channel=32, hidden_size=16,
            character="abc")


@pytest.fixture(scope="module")
def states():
    g = torch.Generator().manual_seed(0)
    return (init_module(VGG_UNet(), g).state_dict(),
            init_module(CRNNet(Config(**_CFG)), g).state_dict())


def _ocr(states, dtype=torch.bfloat16, **kw):
    return BatchedOCR(Config(**_CFG, **kw), *states, boxes_per_image=2, dtype=dtype, device="cpu")


def test_default_plan(states):
    """Tail and s2d on by default, on the CPU as on the card."""
    ocr = _ocr(states)
    assert ocr.fused_kernel_plan(960, 640) == (False, True, False, True)
    assert ocr.fused_kernel_plan(961, 640)[3] is False  # odd canvas: no s2d


@pytest.mark.parametrize("value", ["none", "off", "", "0"])
def test_explicit_none_disables_every_stage(states, monkeypatch, value):
    monkeypatch.setenv("LIGHTLY_OCR_ENABLE_FUSED", value)
    assert _ocr(states, fused_stages="tail,cpool2").fused_kernel_plan(960, 640) == (False,) * 4


@pytest.mark.parametrize("stages,want,warns", [
    ("stem", (False, False, False, False), "fused stem requested"),
    ("cpool", (False, False, False, False), "fused conv1_2+pool requested"),
    ("s2d", (False, False, False, False), "s2d stem requested"),
    ("tail,cpool2", (False, True, "c21", False), None),
    ("tail,cpool2,s2d", (False, True, "c21", False), "s2d stem requested"),
    ("tail,stem", (True, True, False, False), None),
    ("tail", (False, True, False, False), None),
])
def test_env_plan_and_warnings(states, monkeypatch, caplog, stages, want, warns):
    monkeypatch.setenv("LIGHTLY_OCR_ENABLE_FUSED", stages)
    with caplog.at_level(logging.WARNING, logger=batch.__name__):
        ocr = _ocr(states, fused_stages="none")
    assert ocr.fused_kernel_plan(960, 640) == want
    assert (warns is not None) == bool(caplog.text)
    if warns:
        assert warns in caplog.text


def test_config_plans_and_env_override(states, monkeypatch):
    assert _ocr(states, fused_stages="none").fused_kernel_plan(960, 640) == (False,) * 4
    assert _ocr(states, fused_stages="tail,cpool2").fused_kernel_plan(960, 640) == (False, True, "c21", False)
    monkeypatch.setenv("LIGHTLY_OCR_ENABLE_FUSED", "none")
    assert _ocr(states, fused_stages="tail,cpool2").fused_kernel_plan(960, 640) == (False,) * 4


def test_fused_impl_selection(states, monkeypatch, caplog):
    ocr = _ocr(states)
    assert ocr.fused_impls() == (stem.fused_stem_conv, fused_tail_scores_cs_seam, True)
    monkeypatch.setenv("LIGHTLY_OCR_FUSED_IMPL", "rowpack")
    ocr = _ocr(states, fused_stages="tail,stem")
    assert ocr.fused_impls() == (rowpack.stem_conv_rowpacked, rowpack.tail_scores_rowpacked, False)
    assert ocr.front is rowpack.stem_conv_rowpacked and ocr.fused_kernel_plan(960, 640)[:2] == (True, True)
    # rowpack has no seam tail kernel: s2d and cpool gate off (warned when asked explicitly)
    assert _ocr(states).fused_kernel_plan(960, 640) == (False, True, False, False)
    monkeypatch.setenv("LIGHTLY_OCR_ENABLE_FUSED", "tail,s2d")
    with caplog.at_level(logging.WARNING, logger=batch.__name__):
        assert _ocr(states).fused_kernel_plan(960, 640)[3] is False
    assert "s2d stem requested" in caplog.text
    monkeypatch.delenv("LIGHTLY_OCR_ENABLE_FUSED")
    monkeypatch.delenv("LIGHTLY_OCR_FUSED_IMPL")
    ocr = _ocr(states, fused_impl="rowpack")
    assert ocr.fused_impls()[2] is False
    monkeypatch.setenv("LIGHTLY_OCR_FUSED_IMPL", "pallas")  # the env beats the config
    assert _ocr(states, fused_impl="rowpack").fused_impls()[2] is True


def test_config_validation():
    with pytest.raises(ValueError):
        Config(fused_stages="tail,warp9000")
    with pytest.raises(ValueError):
        Config(fused_impl="cuda")
    with pytest.raises(ValueError):
        Config(cpool_pool="magic")  # validated as in the JAX package, though it has no effect
    assert Config(fused_stages="none").derived_fused_stages == frozenset()


def test_rowpack_composition_matches_plain_detector(detector, states):
    """Under ``fused_impl="rowpack"`` with ``tail,stem`` the detector runs
    prefix -> row-packed conv1_2 -> the concat trunk -> the row-packed tail;
    the plain bf16 ``VGG_UNet``'s scores within 5e-3 (the JAX test's
    bound)."""
    v, net, x = detector
    sd = state_dict_from_variables(v)
    ocr = BatchedOCR(Config(**_CFG, fused_stages="tail,stem", fused_impl="rowpack"), sd, states[1],
                     boxes_per_image=2, dtype=torch.bfloat16, device="cpu")
    plain = BatchedOCR(Config(**_CFG, fused_stages="none"), sd, states[1], boxes_per_image=2,
                       dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        got = torch.stack(ocr.detector_scores(torch.from_numpy(x)), -1)
        want = torch.stack(plain.detector_scores(torch.from_numpy(x)), -1)
    assert got.shape == want.shape == (2, 16, 12, 2)
    assert (got - want).abs().max().item() < 5e-3


def test_monolith_switch_exposes_equal_stages(states, monkeypatch):
    """The two stage functions are always exposed and compose to the call;
    ``monolith=False`` / ``LIGHTLY_OCR_MONOLITH=0`` change nothing."""
    rng = np.random.default_rng(5)
    args = (torch.from_numpy(rng.standard_normal((1, 64, 64, 3)).astype(np.float32)),
            torch.from_numpy((rng.random((1, 64, 64)) * 255).astype(np.float32)),
            torch.ones(1), torch.tensor([[64.0, 64.0]]))
    mono = _ocr(states, torch.float32)
    scores, post = mono.stage_fns
    assert scores == mono.detector_scores and post == mono.postprocess
    a = mono(*args)
    with torch.inference_mode():
        b = post(*scores(args[0]), *args[1:])
    monkeypatch.setenv("LIGHTLY_OCR_MONOLITH", "0")
    c = _ocr(states, torch.float32, monolith=False)(*args)
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert torch.equal(a[k], c[k]), k


def test_cpool_pool_switch(states, monkeypatch):
    """The ``cpool`` plan runs kernel #5 whatever ``Config.cpool_pool`` or
    ``LIGHTLY_OCR_CPOOL_POOL`` say; its plain version equals the JAX
    package's reshape formulation of the pool (a max over the 2x2 blocks)."""
    ocr = _ocr(states, fused_stages="tail,cpool")
    assert ocr.front is stem.fused_conv12_pool
    assert _ocr(states, fused_stages="tail,cpool", cpool_pool="reshape").front is stem.fused_conv12_pool
    monkeypatch.setenv("LIGHTLY_OCR_CPOOL_POOL", "reshape")
    assert _ocr(states, fused_stages="tail,cpool").front is stem.fused_conv12_pool
    x0 = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 16, 32, 64)).astype(np.float32))
    p = ocr.stem
    y = stem._conv_bias_relu(x0.to(torch.bfloat16), p.w1, p.b1)
    B, C, H, W = y.shape
    reshaped = y.view(B, C, H // 2, 2, W // 2, 2).amax((3, 5)).permute(0, 2, 3, 1).to(torch.bfloat16)
    assert torch.equal(stem.conv12_pool_plain(x0, p), reshaped)
