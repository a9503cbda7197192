"""int8 serving (w8a8) of the PyTorch port vs the JAX package, on the CPU.

``models/layers.py::QuantConv`` against the JAX ``QuantConv`` over the
geometries the models use, the int8 seam trunk (and its resume points)
against ``VGG_UNetTrunk(seam=True, quant=True)``, the seam 1x1 against the
JAX ``_Split1x1`` in both modes, and the int8 recognizer.  Inputs and
weight perturbations come from seeded numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_ocr_tpu.config import Config as JConfig
from lightly_ocr_tpu.models.crnn import CRNNet as JCRNNet
from lightly_ocr_tpu.models.layers import QuantConv as JQuantConv
from lightly_ocr_tpu.models.vgg_unet import VGG_UNetTrunk as JTrunk
from lightly_ocr_tpu.models.vgg_unet import _Split1x1
from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.layers import QuantConv, int8_conv, tap_major, to_serving
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.weights import state_dict_from_variables

from test_torch_detector import perturbed_detector_vars

# (kernel, stride, padding, dilation): every geometry of a QuantConv in the
# detector and the recognizer (tests/test_quant.py's cases plus 3x3 SAME)
GEOMETRIES = [
    ((3, 3), (1, 1), (1, 1), (1, 1)),
    ((3, 3), (2, 2), (1, 1), (1, 1)),
    ((1, 1), (1, 1), (0, 0), (1, 1)),
    ((2, 2), (2, 1), (0, 1), (1, 1)),
    ((2, 2), (1, 1), (0, 0), (1, 1)),
    ((3, 3), (1, 1), (6, 6), (6, 6)),
]


def _port_conv(v, cin, cout, kernel, stride, padding, dilation, quant=True):
    m = QuantConv(cin, cout, kernel, stride=stride, padding=padding, dilation=dilation,
                  quant=quant)
    m.weight.data = torch.from_numpy(np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
    m.bias.data = torch.from_numpy(np.array(v["params"]["bias"]))
    return m


@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "k{}s{}d{}".format(g[0][0], g[1], g[3][0]))
def test_quantconv_matches_jax_f32(geom):
    """int32 sums are exact on both sides and the scales are computed the
    same way, so the outputs agree to float32 round-off (relative 1e-6;
    measured: bit-identical)."""
    kernel, stride, padding, dilation = geom
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 20, 18, 128)).astype(np.float32)
    q = JQuantConv(128, kernel, strides=stride, dilation=dilation,
                   padding=tuple((p, p) for p in padding), name="c")
    v = jax.tree.map(np.asarray, q.init(jax.random.PRNGKey(2), x))
    v["params"]["bias"] = (0.1 * rng.standard_normal(128)).astype(np.float32)
    ref = np.asarray(q.apply(v, jnp.asarray(x)))
    m = _port_conv(v, 128, 128, kernel, stride, padding, dilation)
    assert m.quantized
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_quantconv_narrow_layers_stay_float():
    """Below 128 channels QuantConv is the float conv: bit-identical to
    ``nn.Conv2d`` and equal to the JAX module to float32 round-off."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 10, 12, 24)).astype(np.float32)
    q = JQuantConv(32, (3, 3), padding=((1, 1), (1, 1)), name="c")
    v = jax.tree.map(np.asarray, q.init(jax.random.PRNGKey(3), x))
    ref = np.asarray(q.apply(v, jnp.asarray(x)))
    m = _port_conv(v, 24, 32, (3, 3), 1, 1, 1)
    assert not m.quantized
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = m(xt)
        plain = torch.nn.functional.conv2d(xt, m.weight, m.bias, padding=1)
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("geom", GEOMETRIES[1:4], ids=["s2", "1x1", "k2s21"])
def test_int8_conv_is_exact(geom):
    """The shifted-tap int8 product equals an int64 direct convolution."""
    kernel, stride, padding, dilation = geom
    rng = np.random.default_rng(3)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 9, 11, 16)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (24, 16, *kernel)).astype(np.int8))
    got = int8_conv(xq, tap_major(w), kernel, stride, padding, dilation)
    ref = torch.nn.functional.conv2d(xq.permute(0, 3, 1, 2).double(), w.double(), stride=stride,
                                     padding=padding, dilation=dilation)
    assert got.dtype == torch.int32
    assert torch.equal(got.permute(0, 3, 1, 2).long(), ref.long())


@pytest.fixture(scope="module")
def det_vars():
    return perturbed_detector_vars(seed=4)


@pytest.mark.parametrize("resume", [None, "pool", "c21"])
def test_int8_seam_trunk_matches_jax(det_vars, resume):
    """``trunk(quant=True)`` vs ``VGG_UNetTrunk(seam=True, quant=True)`` in
    float32, from the canvas and from each resume point.  Both sides
    quantize by the same rules and sum int8 products exactly; the float32
    round-off of the narrow float convs and of BN differs, and where it
    moves a value across a .5 code boundary an int8 code flips and the
    flip spreads through the later layers.  From conv2_2 on (``c21``) no
    float conv precedes the first quantization: round-off only (1e-5 of
    the largest value).  From the canvas or conv2_1, the int8 gates of the
    JAX package's own tests: max |diff| within 3% of the largest value,
    mean |diff| within 0.2% of it (measured 1.4% and 0.08%)."""
    rng = np.random.default_rng(5)
    if resume is None:
        x = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    else:
        c = 64 if resume == "pool" else 128
        x = np.abs(rng.standard_normal((2, 32, 48, c))).astype(np.float32)
    flags = {"pool": dict(from_pool=True), "c21": dict(from_c21=True)}.get(resume, {})
    y_lo, t = JTrunk(seam=True, quant=True, **flags).apply(det_vars, jnp.asarray(x))
    net = VGG_UNet(quant=True)
    net.load_state_dict(state_dict_from_variables(det_vars), strict=True)
    with torch.no_grad():
        y2, t2 = net.eval().trunk(torch.from_numpy(x), resume=resume)
    for got, ref in ((y2.numpy(), np.asarray(y_lo)), (t2.numpy(), np.asarray(t))):
        assert got.shape == ref.shape
        d = np.abs(got - ref)
        scale = np.abs(ref).max()
        if resume == "c21":
            assert d.max() <= 1e-5 * scale
        else:
            assert d.max() <= 3e-2 * scale
            assert d.mean() <= 2e-3 * scale


@pytest.mark.parametrize("quant", [False, True])
def test_seam_1x1_matches_jax_split(det_vars, quant):
    """``UpConv.seam_1x1`` vs the JAX ``_Split1x1`` on the same bf16 pair:
    both halves are float32 results (exact products of bf16 operands, or
    exact int32 sums) summed in float32 with the float32 bias, then one
    cast, so only the float32 summation order differs: at least 99% of the
    bf16 outputs are bit-identical and none is off by more than one bf16
    step of the largest value.  (Rounding each half to bf16 before the
    sum, as cuDNN's bf16 convs do, measured 64.7% bit-identical on these
    inputs.)"""
    rng = np.random.default_rng(6)
    y = rng.standard_normal((2, 8, 12, 128)).astype(np.float32)
    t = np.abs(rng.standard_normal((2, 16, 24, 256))).astype(np.float32)
    yb, tb = (jnp.asarray(a, jnp.bfloat16) for a in (y, t))
    params = {"params": det_vars["params"]["upconv3"]["conv"]["0"]}
    ref = np.asarray(_Split1x1(128, 128, jnp.bfloat16, quant).apply(params, yb, tb), np.float32)
    net = VGG_UNet(quant=quant)
    net.load_state_dict(state_dict_from_variables(det_vars), strict=True)
    to_serving(net, "cpu", torch.bfloat16)
    yt, tt = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).permute(0, 3, 1, 2)
              for a in (yb, tb))
    with torch.no_grad():
        got = net.upconv3.seam_1x1(yt, tt).permute(0, 2, 3, 1).float().numpy()
    assert got.shape == ref.shape
    step = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)  # bf16 spacing at max |ref|
    assert np.abs(got - ref).max() <= step
    assert np.mean(got == ref) >= 0.99


def test_bf16_seam_pair_matches_jax_trunk(det_vars):
    """The whole bf16 seam trunk vs the JAX trunk in bf16.  The convs round
    their bf16 outputs in different orders on the two sides, so values
    agree to a few bf16 steps: max |diff| within 3% of the largest value
    and the mean |diff| within 0.3% of it (the seam 1x1 itself is held
    bit-tight in ``test_seam_1x1_matches_jax_split``)."""
    x = np.random.default_rng(1).standard_normal((2, 64, 96, 3)).astype(np.float32)
    y_lo, t = JTrunk(dtype=jnp.bfloat16, seam=True).apply(det_vars, jnp.asarray(x))
    net = VGG_UNet()
    net.load_state_dict(state_dict_from_variables(det_vars), strict=True)
    to_serving(net, "cpu", torch.bfloat16)
    with torch.no_grad():
        y2, t2 = net.eval().trunk(torch.from_numpy(x))
    for got, ref in ((y2, y_lo), (t2, t)):
        got, ref = got.float().numpy(), np.asarray(ref, np.float32)
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= 3e-2 * scale
        assert np.abs(got - ref).mean() <= 3e-3 * scale


def test_int8_recognizer_matches_jax():
    """CRNN with the int8 ResNet (``output_channel=256``, so layers of 128
    and 256 channels quantize) vs the JAX ``CRNNet(quant=True)`` in float32:
    greedy logits to 1e-3 of their scale, argmax identical."""
    kw = dict(prediction="Attention", transform="TPS", output_channel=256, hidden_size=32,
              character="abcdefghij", batch_max_len=8)
    jcfg = JConfig(**kw)
    x = np.random.default_rng(8).standard_normal((3, 32, 100, 1)).astype(np.float32)
    v = jax.tree.map(np.asarray, JCRNNet(jcfg).init(jax.random.key(1), jnp.zeros((2, 32, 100, 1)),
                                                   None, False))
    ref = np.asarray(JCRNNet(jcfg, quant=True).apply(v, jnp.asarray(x), None, False))
    net = CRNNet(Config(**kw), quant=True)
    net.load_state_dict(state_dict_from_variables(v), strict=True)
    assert net.FeatureExtraction.ConvNet.layer3[0].conv1.quantized
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-3 * max(1.0, np.abs(ref).max())
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))


def test_to_serving_keeps_float32_masters():
    """After ``to_serving(..., bfloat16)`` a QuantConv's int8 codes and bias
    come from the float32 master, not from the bf16-rounded parameters."""
    g = torch.Generator().manual_seed(0)
    m = QuantConv(128, 128, 3, padding=1, quant=True)
    torch.nn.init.normal_(m.weight, generator=g)
    torch.nn.init.normal_(m.bias, generator=g)
    w32, b32 = m.weight.detach().clone(), m.bias.detach().clone()
    to_serving(m, "cpu", torch.bfloat16)
    assert m.weight.dtype == torch.bfloat16
    w, b = m.master()
    assert w.dtype == b.dtype == torch.float32
    assert torch.equal(w, w32) and torch.equal(b, b32)
