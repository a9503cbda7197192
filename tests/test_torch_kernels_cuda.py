"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode; their plain versions are held against the JAX
package in ``test_torch_seam_tail.py``, ``test_torch_cc.py`` and
``test_torch_stem.py``).  This
file imports nothing of JAX, so it runs on the card's machine, which has
no JAX, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from lightly_ocr_tpu_torch.models.layers import init_module
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.ops import cc
from lightly_ocr_tpu_torch.ops import seam_tail as st
from lightly_ocr_tpu_torch.ops import stem

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# the fused tail kernel's edges (tests/test_torch_seam_tail.py replays its
# cut on the CPU): a strip of two columns, a segment of two rows, >= 2 strips
# and segments, and one full main-path map (a 960x640 canvas)
_TAIL_EDGES = [(1, 16, st.STRIP_COLS + 2), (1, st.SEGMENT_ROWS + 2, 8),
               (2, 2 * st.SEGMENT_ROWS + 2, 2 * st.STRIP_COLS + 2), (1, 480, 320)]
_TAIL_EDGE_IDS = ["strip2", "segment2", "strips_segments", "main_path"]


def test_tail_kernel_geometry(cuda_device):
    assert st.kernel_geometry() == (st.STRIP_COLS, st.SEGMENT_ROWS, st.HALO)


@pytest.mark.parametrize("shape", [(2, 48, 32), (1, 30, 50), (3, 2, 2), *_TAIL_EDGES],
                         ids=["2x48x32", "1x30x50", "3x2x2", *_TAIL_EDGE_IDS])
def test_seam_tail_kernel_matches_plain(cuda_device, shape):
    """Even H2, W2 of any size, including a single 2x2 map (every pixel
    an edge pixel); tolerance relative to the scores, as in chip_smoke."""
    B, H2, W2 = shape
    net = init_module(VGG_UNet(), torch.Generator().manual_seed(1))
    p = st.tail_params(net, torch.bfloat16)
    p = type(p)(*(a.to(cuda_device) for a in p))
    g = torch.Generator().manual_seed(0)
    ya = torch.randn(B, H2 // 2, W2 // 2, 64, generator=g).to(cuda_device)
    t = torch.randn(B, H2, W2, 128, generator=g).to(cuda_device, torch.bfloat16)
    n = st.seam_tail.launches
    got = st.seam_tail(ya, t, p)
    torch.cuda.synchronize()
    assert st.seam_tail.launches == n + 1
    ref = st.seam_tail_plain(ya, t, p)
    assert got.shape == ref.shape == (B, H2, 2, W2)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()
    assert (got == ref).float().mean().item() >= 0.9


def test_seam_tail_kernel_rejects_bad_input(cuda_device):
    net = init_module(VGG_UNet(), torch.Generator().manual_seed(1))
    p = st.tail_params(net, torch.bfloat16)
    p = type(p)(*(a.to(cuda_device) for a in p))
    ya = torch.zeros(1, 4, 4, 64, device=cuda_device)
    with pytest.raises(ValueError):
        st.seam_tail(ya, torch.zeros(1, 8, 8, 128, device=cuda_device), p)  # f32 t
    with pytest.raises(ValueError):
        st.seam_tail(ya, torch.zeros(1, 8, 9, 128, device=cuda_device,
                                     dtype=torch.bfloat16), p)  # odd width


# the CC kernel's strip edges (tests/test_torch_cc.py -k strip replays its
# cut on the CPU): one row, one row short of a strip, one strip, one row into
# the second and into the third, at W = 1, odd widths and the main-path width
_CC_EDGES = {f"h{name}_w{w}": (2, h(cc.strip_rows(w)), w)
             for name, h in (("1", lambda R: 1), ("R-1", lambda R: R - 1), ("R", lambda R: R),
                             ("R+1", lambda R: R + 1), ("2R+1", lambda R: 2 * R + 1))
             for w in (1, 7, 33, 320)}


def _cc_mask(case):
    r = np.random.default_rng(7)
    masks = {
        "random": r.random((1, 96, 80)) > 0.45,
        "dense": r.random((2, 480, 320)) > 0.3,
        "spiral": cc.spiral_mask(480, 320)[None],
        "comb": cc.comb_mask(128, 256)[None],
        "batch": r.random((4, 48, 64)) > 0.5,
        "empty": np.zeros((2, 16, 16), bool),
    }
    if case in masks:
        return masks[case]
    r = np.random.default_rng(8)
    if case in _CC_EDGES:
        return r.random(_CC_EDGES[case]) < 0.59  # near the site-percolation threshold
    return {
        "comb_480x320": lambda: cc.comb_mask(480, 320)[None],
        "b2_640x640": lambda: r.random((2, 640, 640)) < 0.59,
        "all_fg": lambda: np.ones((3, 3 * cc.strip_rows(17), 17), bool),
        "percolation_b16": lambda: r.random((16, 480, 320)) < 0.59,
        "checkerboard": lambda: (np.indices((3 * cc.strip_rows(45) + 5, 45)).sum(0) % 2 == 0)[None],
    }[case]()


@pytest.mark.parametrize("case", ["random", "dense", "spiral", "comb", "comb_480x320", "batch",
                                  "empty", "b2_640x640", "all_fg", "percolation_b16",
                                  "checkerboard", *_CC_EDGES])
def test_cc_kernel_matches_plain(cuda_device, case):
    fg = torch.from_numpy(_cc_mask(case)).to(cuda_device)
    n = cc.label_components.launches
    got = cc.label_components(fg)
    torch.cuda.synchronize()
    assert cc.label_components.launches == n + 1
    assert torch.equal(got, cc.label_components_plain(fg))
    assert cc.labels_converged(fg, got)


def test_cc_phase_prefixes(cuda_device):
    """The timing split's prefixes: the strip launch alone labels each strip
    on its own (the replay's first step), all three give the labels, and
    none counts as a launch of the wrapper."""
    R = cc.strip_rows(64)
    mask = cc.comb_mask(3 * R + 5, 64)[None]
    fg = torch.from_numpy(mask).to(cuda_device)
    n = cc.label_components.launches
    (_, strip), _, (_, full) = cc.phase_prefixes(fg)
    got_strip, got = strip(), full()
    torch.cuda.synchronize()
    assert cc.label_components.launches == n
    assert torch.equal(got, cc.label_components_plain(fg))
    for r0 in range(0, mask.shape[1], R):
        piece = fg[:, r0:r0 + R]
        want = torch.where(piece, cc.label_components_plain(piece) + r0 * 64, mask.shape[1] * 64)
        assert torch.equal(got_strip[:, r0:r0 + R], want), r0


def test_cc_kernel_geometry(cuda_device):
    """``cc_geometry`` of the library equals ``ops/cc.py``'s mirror, for
    every map width of the canvas buckets, odd widths, the widths where a
    strip becomes one row, and up to widths where no row fits."""
    for W in (*range(32, 641, 32), 1, 7, 33, 2047, 2048, 4000, 12000, 12900, 13000, 23000):
        assert cc.kernel_geometry(W) == cc.geometry(W), W


def test_cc_kernel_rejects_bad_input(cuda_device):
    with pytest.raises(ValueError):
        cc.label_components(torch.zeros(1, 4, 4, dtype=torch.uint8, device=cuda_device))
    with pytest.raises(ValueError):  # no strip row fits in shared memory
        cc.label_components(torch.zeros(1, 1, cc.SMEM_BUDGET // 5, dtype=torch.bool,
                                        device=cuda_device))


@pytest.fixture
def stem_setup(cuda_device, monkeypatch):
    # the plain versions' float32 convolutions in full float32, not TF32
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    net = init_module(VGG_UNet(), torch.Generator().manual_seed(2))
    p = stem.stem_params(net)
    return type(p)(*(a.to(cuda_device) for a in p))


STEM_KERNELS = ["fused_conv12_pool", "fused_conv12_pool_conv21", "fused_conv12_pool_conv21_q"]

# conv3x3_hopper's edges (tests/test_torch_stem.py replays its cut on the
# CPU): a W past one conv1_2 strip (W/2 past one conv2_1 strip), an H past
# two conv1_2 segments (H/2 past two conv2_1 segments), one full main-path
# canvas
_HOPPER_EDGES = [(1, 4, stem.STRIP_COLS[64] + 16), (1, 2 * stem.SEGMENT_ROWS[64] + 4, 16),
                 (1, 960, 640)]
_HOPPER_EDGE_IDS = ["strip_edge", "segment_edge", "main_path"]


def test_stem_kernel_geometry(cuda_device):
    assert stem.kernel_geometry() == stem.geometry()


# #7's requant blocks (rows / 2 pooled rows, tests/test_torch_stem.py
# replays them on the CPU): two blocks of r2 = 2 across a conv2_1 strip
# edge (W2 = 72), and four blocks of r2 = 16 over three strips in a batch
_REQUANT_EDGES = [(1, 12, 144), (2, 128, 272)]
_REQUANT_EDGE_IDS = ["requant_r2_2", "requant_r2_16"]


@pytest.mark.parametrize("shape", [(3, 64, 48), (1, 2, 16), (2, 66, 32), (1, 96, 160),
                                   *_HOPPER_EDGES, *_REQUANT_EDGES],
                         ids=["odd_batch", "smallest", "rows2_odd_h2", "wide", *_HOPPER_EDGE_IDS,
                              *_REQUANT_EDGE_IDS])
@pytest.mark.parametrize("name", STEM_KERNELS)
def test_stem_kernel_matches_plain(cuda_device, stem_setup, name, shape):
    """#5/#6: the same bf16 operands summed in another order: at least 90%
    of outputs bit-identical, max |diff| within 1% of the largest.  #7:
    exact int8 products and the plain version's rounding: at least 99%
    bit-identical, max |diff| within 1% of the largest (and, below, all of
    them)."""
    B, H, W = shape
    assert stem.conv_pool_supported(H, W)
    fn = getattr(stem, name)
    g = torch.Generator().manual_seed(3)
    x0 = torch.relu(torch.randn(B, H, W, 64, generator=g)).to(cuda_device, torch.bfloat16)
    n = fn.launches
    got = fn(x0, stem_setup)
    torch.cuda.synchronize()
    assert fn.launches == n + 1
    plain = getattr(stem, name.replace("fused_", "") + "_plain")
    ref = plain(x0, stem_setup)
    assert got.shape == ref.shape and got.dtype == ref.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()
    exact = (got == ref).float().mean().item()
    assert exact >= (0.99 if name.endswith("_q") else 0.9)


@pytest.mark.parametrize("shape", [(2, 66, 32), (1, 64, 144), *_REQUANT_EDGES],
                         ids=["requant_r2_1", "requant_2_blocks", *_REQUANT_EDGE_IDS])
def test_int8_stem_kernel_is_bit_identical(cuda_device, stem_setup, shape):
    """#7 sums int8 products exactly and rounds every scale, dequant and
    requant as its plain version does, so the two agree bit for bit; its
    four launches, run one by one, give that output."""
    B, H, W = shape
    g = torch.Generator().manual_seed(6)
    x0 = torch.relu(torch.randn(B, H, W, 64, generator=g)).to(cuda_device, torch.bfloat16)
    out, steps = stem.int8_launches(x0, stem_setup)
    assert [name for name, _ in steps] == ["sample_amax_bf16", "quantize_bf16", "conv12_pool_s8",
                                           "conv21_s8"]
    for _, launch in steps:
        launch()
    torch.cuda.synchronize()
    assert torch.equal(out, stem.conv12_pool_conv21_q_plain(x0, stem_setup))


def test_stem_kernels_reject_bad_input(cuda_device, stem_setup):
    x = torch.zeros(1, 32, 32, 64, device=cuda_device)
    with pytest.raises(ValueError):
        stem.fused_conv12_pool(x, stem_setup)  # f32 x0
    with pytest.raises(ValueError):
        stem.fused_conv12_pool_conv21_q(x.to(torch.bfloat16)[:, :, :24].contiguous(), stem_setup)  # W % 16


@pytest.mark.parametrize("shape", [(3, 64, 48), (1, 4, 8), (2, 68, 32), (1, 96, 160),
                                   (1, 8, stem.STRIP_COLS[64] + 8), *_HOPPER_EDGES[1:]],
                         ids=["odd_batch", "smallest", "h68", "wide", *_HOPPER_EDGE_IDS])
def test_stem_conv_kernel_matches_plain(cuda_device, stem_setup, shape):
    """#4, the full-resolution conv1_2: H a multiple of 4 (68: not of 8),
    W a multiple of 8 (partial strips); the gate of #5/#6."""
    B, H, W = shape
    assert stem.stem_supported(H) and W % 8 == 0
    g = torch.Generator().manual_seed(4)
    x0 = torch.relu(torch.randn(B, H, W, 64, generator=g)).to(cuda_device, torch.bfloat16)
    n = stem.fused_stem_conv.launches
    got = stem.fused_stem_conv(x0, stem_setup)
    torch.cuda.synchronize()
    assert stem.fused_stem_conv.launches == n + 1
    ref = stem.fused_stem_conv_plain(x0, stem_setup)
    assert got.shape == ref.shape == (B, H, W, 64) and got.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()
    assert (got == ref).float().mean().item() >= 0.9


@pytest.mark.parametrize("shape", [(3, 48, 32), (1, 2, 2), (1, 96, 160), (1, 30, 50),
                                   *_TAIL_EDGES],
                         ids=["odd_batch", "2x2", "wide", "1x30x50", *_TAIL_EDGE_IDS])
def test_tail_kernel_matches_plain(cuda_device, shape):
    """#3, the tail chain from a formed x; the seam tail's gate."""
    B, H2, W2 = shape
    net = init_module(VGG_UNet(), torch.Generator().manual_seed(1))
    p = st.tail_params(net, torch.bfloat16)
    p = type(p)(*(a.to(cuda_device) for a in p))
    g = torch.Generator().manual_seed(5)
    x = torch.relu(torch.randn(B, H2, W2, 64, generator=g)).to(cuda_device, torch.bfloat16)
    n = st.tail_scores.launches
    got = st.tail_scores(x, p)
    torch.cuda.synchronize()
    assert st.tail_scores.launches == n + 1
    ref = st.tail_scores_plain(x, p)
    assert got.shape == ref.shape == (B, H2, 2, W2)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()
    assert (got == ref).float().mean().item() >= 0.9


def test_stem_conv_and_tail_kernels_reject_bad_input(cuda_device, stem_setup):
    net = init_module(VGG_UNet(), torch.Generator().manual_seed(1))
    p = st.tail_params(net, torch.bfloat16)
    p = type(p)(*(a.to(cuda_device) for a in p))
    bf = dict(device=cuda_device, dtype=torch.bfloat16)
    for fn, params, shape in ((stem.fused_stem_conv, stem_setup, (1, 8, 16)),
                              (st.tail_scores, p, (1, 8, 16))):
        with pytest.raises(ValueError):
            fn(torch.zeros(*shape, 64, device=cuda_device), params)  # f32
        with pytest.raises(ValueError):
            fn(torch.zeros(*shape, 32, **bf), params)  # channels
        with pytest.raises(ValueError):
            fn(torch.zeros(1, shape[2], shape[1], 64, **bf).transpose(1, 2), params)  # non-contiguous
    with pytest.raises(ValueError):
        stem.fused_stem_conv(torch.zeros(1, 6, 16, 64, **bf), stem_setup)  # H % 4
    with pytest.raises(ValueError):
        st.tail_scores(torch.zeros(1, 8, 9, 64, **bf), p)  # odd width
