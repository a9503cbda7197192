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
import torch.nn.functional as F

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


# -- the CUDA kernel's cut of the map, replayed in PyTorch --------------------
# Integer-valued operands keep every float32 sum exact whatever its order,
# so the stitched pieces must equal the whole-map plain versions bit for bit.


def _int_params(seed: int) -> st.TailParams:
    rng = np.random.default_rng(seed)

    def w(*shape, dense=0.25):  # {-1, 0, 1}
        q = [dense / 2, 1 - dense, dense / 2]
        return torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], size=shape, p=q).astype(np.float32))

    def b(n):  # positive biases make relu(bias) != 0 outside the image
        return torch.from_numpy(rng.integers(-1, 3, n).astype(np.float32))

    return st.TailParams(k1a=w(64, 64), k1b=w(128, 64), b1=b(64), wa=w(9, 64, 32), ba=b(32),
                         w0=w(9, 32, 32), b0=b(32), w2=w(9, 32, 32), b2=b(32), w4=w(9, 32, 16),
                         b4=b(16), w6=w(16, 16, dense=0.5), b6=b(16), w8=w(16, 2, dense=1.0),
                         b8=b(2))


def _window(a, r0, r1, c0, c1):
    """``a`` [H, W, C] cut to rows [r0, r1), cols [c0, c1), zeros outside."""
    H, W, C = a.shape
    out = a.new_zeros((r1 - r0, c1 - c0, C))
    rr0, rr1, cc0, cc1 = max(r0, 0), min(r1, H), max(c0, 0), min(c1, W)
    if rr0 < rr1 and cc0 < cc1:
        out[rr0 - r0:rr1 - r0, cc0 - c0:cc1 - c0] = a[rr0:rr1, cc0:cc1]
    return out


def _up2x_window(ya, r0, r1, c0, c1):
    """The 2x bilinear upsample of ``ya`` [H4, W4, 64] on the map window
    rows [r0, r1), cols [c0, c1) (even bounds), from the ya rows and
    columns of the window and one more on each side, clamped only at the
    image edge: what a block stages.  Zeros outside the image."""
    H4, W4, _ = ya.shape
    ya0, ya1 = max(r0 // 2 - 1, 0), min(r1 // 2 + 1, H4)
    xa0, xa1 = max(c0 // 2 - 1, 0), min(c1 // 2 + 1, W4)
    src = ya[ya0:ya1, xa0:xa1].permute(2, 0, 1)[None]
    up = F.interpolate(src, size=(2 * (ya1 - ya0), 2 * (xa1 - xa0)), mode="bilinear",
                       align_corners=False)[0].permute(1, 2, 0)
    return _window(up, r0 - 2 * ya0, r1 - 2 * ya0, c0 - 2 * xa0, c1 - 2 * xa0)


def _replay(p, H2, W2, x=None, ya=None, t=None):
    """Scores [B, H2, 2, W2] stitched from the kernel's blocks: each block
    takes its strip and segment with HALO more on every side, runs the
    plain chain on that piece with the activations outside the image set
    to zero after every layer, and keeps the centre."""
    tw, seg, halo = st.STRIP_COLS, st.SEGMENT_ROWS, st.HALO
    B = (x if x is not None else t).shape[0]
    out = torch.full((B, H2, 2, W2), float("nan"))
    convs = ((p.wa, p.ba), (p.w0, p.b0), (p.w2, p.b2), (p.w4, p.b4))
    for b in range(B):
        for c0 in range(0, W2, tw):
            for s0 in range(0, H2, seg):
                r0, r1 = s0 - halo, min(s0 + seg, H2) + halo
                w0, w1 = c0 - halo, c0 + tw + halo
                rows, cols = torch.arange(r0, r1), torch.arange(w0, w1)
                inside = (((rows >= 0) & (rows < H2))[:, None]
                          & ((cols >= 0) & (cols < W2))[None, :])[None, None].float()
                if x is not None:
                    v = _window(x[b], r0, r1, w0, w1)
                else:
                    up = _up2x_window(ya[b], r0, r1, w0, w1)
                    v = F.relu(up + _window(t[b], r0, r1, w0, w1) @ p.k1b + p.b1)
                v = v.permute(2, 0, 1)[None] * inside
                for wk, bk in convs:
                    oihw = wk.reshape(3, 3, wk.shape[1], wk.shape[2]).permute(3, 2, 0, 1)
                    v = F.relu(F.conv2d(v, oihw, bk, padding=1)) * inside
                v = F.relu(F.conv2d(v, p.w6.t()[:, :, None, None], p.b6))
                v = F.conv2d(v, p.w8.t()[:, :, None, None], p.b8)[0]  # [2, rows, cols]
                n_r, n_c = min(s0 + seg, H2) - s0, min(c0 + tw, W2) - c0
                out[b, s0:s0 + n_r, :, c0:c0 + n_c] = (
                    v[:, halo:halo + n_r, halo:halo + n_c].permute(1, 0, 2))
    return out


# every edge: a single 2x2 map, ragged strips and segments, a strip of two
# columns, a segment of two rows (H2 and W2 are even), >= 2 of both
_CUT_SHAPES = [(2, 2, 2), (2, 30, 50), (1, 48, 32), (1, 16, st.STRIP_COLS + 2),
               (1, st.SEGMENT_ROWS + 2, 8), (1, 2 * st.SEGMENT_ROWS + 2, 2 * st.STRIP_COLS + 2)]


def test_kernel_geometry_fits_its_tiles():
    """Every layer of a block computes STRIP_COLS + 2 HALO columns of a row
    as m16 tiles, and the halo covers the four 3x3 convs."""
    assert (st.STRIP_COLS + 2 * st.HALO) % 16 == 0
    assert st.HALO == 4 and st.STRIP_COLS % 2 == 0


@pytest.mark.parametrize("kernel", ["tail", "seam"])
@pytest.mark.parametrize("shape", _CUT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_cut_stitches_to_plain(kernel, shape):
    """The kernel's strips and segments with their halos, the out-of-image
    rezero and (seam) the upsample's staged ya window, replayed on the plain
    chain, stitch to the whole-map plain version exactly (float32)."""
    B, H2, W2 = shape
    p = _int_params(7)
    rng = np.random.default_rng(H2 * 1000 + W2)
    if kernel == "tail":
        x = torch.from_numpy(rng.integers(0, 4, (B, H2, W2, 64)).astype(np.float32))
        ref = st.tail_scores_plain(x, p)
        got = _replay(p, H2, W2, x=x)
    else:
        ya = torch.from_numpy(rng.integers(-4, 5, (B, H2 // 2, W2 // 2, 64)).astype(np.float32))
        t = torch.from_numpy(rng.integers(-2, 3, (B, H2, W2, 128)).astype(np.float32))
        ref = st.seam_tail_plain(ya, t, p)
        got = _replay(p, H2, W2, ya=ya, t=t)
    assert ref.abs().max() < 2 ** 20  # integer sums stay exact in float32
    assert ref.unique().numel() > ref.numel() // 8  # the signal reaches the scores
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
