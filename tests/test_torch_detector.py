"""CRAFT detector of the PyTorch port vs the JAX package, float32 on CPU.

Covers ``models/vgg_unet.py`` (the full detector and the seam-form trunk)
and ``ops/image.py`` (resize plan and detector input).  Weights come from
the JAX init with every BatchNorm and bias perturbed by seeded numpy noise,
so the folds and the in-place-ReLU dataflow are exercised.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_ocr_tpu.models.vgg_unet import VGG_UNet as JVGG_UNet
from lightly_ocr_tpu.models.vgg_unet import VGG_UNetTrunk as JTrunk
from lightly_ocr_tpu.ops import image as jimage
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.ops import image as timage
from lightly_ocr_tpu_torch.weights import state_dict_from_variables


def perturbed_detector_vars(seed=0):
    rng = np.random.default_rng(seed)
    v = jax.tree.map(np.asarray, JVGG_UNet().init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3))))

    def walk(tree):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict):
                out[k] = walk(x)
            elif k in ("bias", "mean"):
                out[k] = (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)
            elif k in ("scale", "var"):
                out[k] = (x * rng.uniform(0.8, 1.2, x.shape)).astype(np.float32)
            else:
                out[k] = x
        return out

    return walk(v)


@pytest.fixture(scope="module")
def detector():
    v = perturbed_detector_vars()
    net = VGG_UNet()
    net.load_state_dict(state_dict_from_variables(v), strict=True)
    x = np.random.default_rng(1).standard_normal((2, 64, 96, 3)).astype(np.float32)
    return v, net.eval(), x


def test_scores_match_jax_f32(detector):
    v, net, x = detector
    ref, ref_feat = JVGG_UNet().apply(v, jnp.asarray(x))
    with torch.no_grad():
        got, feat = net(torch.from_numpy(x))
    assert got.shape == (2, 32, 48, 2) and feat.shape == (2, 32, 48, 32)
    ref = np.asarray(ref)
    # f32 round-off through 20 conv layers; scores are O(0.1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))
    np.testing.assert_allclose(feat.numpy(), np.asarray(ref_feat), rtol=0, atol=1e-4)


def test_seam_pair_matches_jax_f32(detector):
    v, net, x = detector
    y_lo, t = JTrunk(seam=True).apply(v, jnp.asarray(x))
    with torch.no_grad():
        y2, t2 = net.trunk(torch.from_numpy(x))
    assert y2.shape == (2, 16, 24, 64) and t2.shape == (2, 32, 48, 128)
    np.testing.assert_allclose(y2.numpy(), np.asarray(y_lo), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t2.numpy(), np.asarray(t), rtol=0, atol=1e-4)


@pytest.mark.parametrize("hw", [(600, 400), (120, 90), (320, 260), (1000, 90)])
def test_resize_plan_and_buckets(hw):
    h, w = hw
    for gran in (32, 64):
        cb = timage.pick_canvas_bucket(h, w, 1280, 1.5, granularity=gran)
        assert cb == jimage.pick_canvas_bucket(h, w, 1280, 1.5, granularity=gran)
        assert tuple(timage.plan_aspect_resize(h, w, 1280, 1.5, canvas_bucket=cb)) == \
            tuple(jimage.plan_aspect_resize(h, w, 1280, 1.5, canvas_bucket=cb))
    assert timage.pick_gray_bucket(h, w, 256) == jimage.pick_gray_bucket(h, w, 256)


def test_serving_geometry_of_a_600x400_receipt():
    cb = timage.pick_canvas_bucket(600, 400, 1280, 1.5, granularity=64)
    plan = timage.plan_aspect_resize(600, 400, 1280, 1.5, canvas_bucket=cb)
    assert (plan.target_h, plan.target_w) == (900, 600)
    assert cb == (960, 640) and (plan.heatmap_h, plan.heatmap_w) == (480, 320)
    assert timage.pick_gray_bucket(600, 400, 256) == (768, 512)


@pytest.mark.parametrize("hw,canvas", [((40, 30), 64), ((70, 50), 64)])
def test_detector_input_matches_jax(hw, canvas):
    """Upscale (magnify) and downscale (content capped by the bucket)."""
    h, w = hw
    img = np.random.default_rng(2).integers(0, 256, (h, w, 3)).astype(np.float32)
    cb = (canvas, canvas)
    plan = jimage.plan_aspect_resize(h, w, canvas, 1.5, canvas_bucket=cb)
    ref, _ = jimage.make_detector_input(jnp.asarray(img), plan)
    got = timage.make_detector_input(torch.from_numpy(img), timage.ResizePlan(*plan))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
