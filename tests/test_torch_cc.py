"""Connected components of the PyTorch port (``ops/cc.py``) vs the JAX package.

The plain version must give EXACTLY the JAX labels (min linear index per
4-connected component, background H*W) of the Pallas kernel in interpret
mode and of the XLA ``label_components``; on adversarial snakes, where the
round-bounded Pallas kernel stops short and the JAX package escalates, the
port is exact without escalation (checked against scipy-derived labels).
The CUDA kernel is held against the plain version in
``test_torch_kernels_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from lightly_ocr_tpu.ops.detection import label_components as jlabel
from lightly_ocr_tpu.ops.pallas_cc import (
    label_components_checked,
    label_components_pallas,
    labels_converged as jconverged,
)
from lightly_ocr_tpu_torch.ops import cc


def min_index_labels(mask):
    """scipy 4-connected labelling, relabelled to min linear index."""
    lab, n = ndimage.label(mask)
    H, W = mask.shape
    out = np.full(mask.shape, H * W, np.int32)
    lin = np.arange(H * W).reshape(H, W)
    if n:
        mins = ndimage.minimum(lin, lab, index=np.arange(1, n + 1)).astype(np.int32)
        out[mask] = mins[lab[mask] - 1]
    return out


def _masks():
    r = np.random.default_rng(5)
    blobs = np.zeros((24, 40), bool)
    blobs[3:8, 2:20] = True
    blobs[12:20, 10:38] = True
    blobs[21:23, 1:4] = True
    lshape = np.zeros((24, 40), bool)
    lshape[2:20, 3] = True
    lshape[19, 3:35] = True
    return {
        "random": r.random((24, 40)) > 0.65,
        "blobs": blobs,
        "lshape": lshape,
        "empty": np.zeros((24, 40), bool),
    }


@pytest.mark.parametrize("name", ["random", "blobs", "lshape", "empty"])
def test_plain_matches_pallas_and_xla(name):
    mask = _masks()[name]
    got = cc.label_components_plain(torch.from_numpy(mask)).numpy()
    xla = np.asarray(jlabel(jnp.asarray(mask), max_rounds=64))
    # the JAX serving path: 4 Pallas rounds, then the convergence check
    # and its XLA escalation where 4 rounds stop short
    pallas = np.asarray(label_components_checked(
        jnp.asarray(mask), rounds=4, max_rounds=64, interpret=True))
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, min_index_labels(mask))


def test_plain_batched_matches_pallas():
    masks = np.stack(list(_masks().values()))
    got = cc.label_components_plain(torch.from_numpy(masks)).numpy()
    ref = np.asarray(label_components_checked(
        jnp.asarray(masks), rounds=4, max_rounds=64, interpret=True))
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32


@pytest.mark.parametrize("maker,shape", [(cc.spiral_mask, (64, 128)), (cc.comb_mask, (64, 128)),
                                         (cc.spiral_mask, (480, 320))])
def test_plain_exact_where_bounded_rounds_stop_short(maker, shape):
    """The JAX Pallas kernel needs its XLA escalation on these snakes; the
    port's labelling is exact outright."""
    mask = maker(*shape)
    got = cc.label_components_plain(torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), min_index_labels(mask))
    assert len(set(got.numpy()[mask].tolist())) == 1
    assert cc.labels_converged(torch.from_numpy(mask), got)
    if shape == (64, 128):
        under = label_components_pallas(jnp.asarray(mask), rounds=2, interpret=True)
        assert not bool(jconverged(jnp.asarray(mask), under))


def test_labels_converged_detects_a_broken_fixed_point():
    mask = _masks()["blobs"]
    lab = cc.label_components_plain(torch.from_numpy(mask))
    assert cc.labels_converged(torch.from_numpy(mask), lab)
    bad = lab.clone()
    bad[5, 10] = 999
    assert not cc.labels_converged(torch.from_numpy(mask), bad)
    assert bool(jconverged(jnp.asarray(mask), jnp.asarray(lab.numpy())))


def test_wrapper_takes_plain_version_on_cpu():
    mask = torch.from_numpy(_masks()["random"])
    before = cc.label_components.launches
    np.testing.assert_array_equal(cc.label_components(mask).numpy(),
                                  cc.label_components_plain(mask).numpy())
    assert cc.label_components.launches == before


# -- the kernel's strip cut, replayed on the CPU ------------------------------

def _replay_strips(mask):
    """``csrc/cc.cu``'s three launches replayed in torch/numpy, with the
    strip rows that ``ops/cc.py``'s geometry mirror gives for ``W``:
    ``cc_strip`` labels each strip of R full-width rows on its own (its
    local minimum index, offset by the strip's first pixel); ``cc_seams``
    unites, by min-linking, the roots of each foreground pair across a seam
    whose left pair is not also foreground; ``cc_flatten`` follows every
    label to its root."""
    fg = torch.as_tensor(mask)
    fg = fg[None] if fg.ndim == 2 else fg
    B, H, W = fg.shape
    R, HW = cc.strip_rows(W), H * W
    labels = torch.full((B, H, W), HW, dtype=torch.int32)
    for r0 in range(0, H, R):
        piece = fg[:, r0:r0 + R]
        labels[:, r0:r0 + R] = torch.where(piece, cc.label_components_plain(piece) + r0 * W, HW)
    p = np.concatenate([labels.view(B, HW).numpy(), np.full((B, 1), HW, np.int32)], 1)
    m = fg.numpy()

    def find(pb, x):
        while pb[x] != x:
            x = pb[x]
        return x

    for b in range(B):
        for r in range(R, H, R):
            above, below = m[b, r - 1], m[b, r]
            for c in np.flatnonzero(above & below):
                if c > 0 and above[c - 1] and below[c - 1]:
                    continue
                a, d = find(p[b], (r - 1) * W + c), find(p[b], r * W + c)
                p[b, max(a, d)] = min(a, d)
    lab = p[:, :HW]
    while True:
        nxt = np.take_along_axis(p, lab, 1)
        if np.array_equal(nxt, lab):
            break
        lab = nxt
    return torch.from_numpy(lab.reshape(B, H, W))


_STRIP_H = {"1": lambda R: 1, "R-1": lambda R: R - 1, "R": lambda R: R,
            "R+1": lambda R: R + 1, "2R+1": lambda R: 2 * R + 1}


def _strip_case(name):
    R = cc.strip_rows(17)
    r = np.random.default_rng(11)
    if name == "all_fg":
        return np.ones((1, 3 * R, 17), bool)
    if name == "percolation":
        return r.random((2, 96, 80)) < 0.59  # near the site-percolation threshold
    if name == "checkerboard":
        ii, jj = np.indices((3 * R + 5, 45))
        return ((ii + jj) % 2 == 0)[None]  # no 4-connected pair at all
    maker, H, W = {"spiral_480x320": (cc.spiral_mask, 480, 320),
                   "comb_480x320": (cc.comb_mask, 480, 320),
                   "spiral_128x256": (cc.spiral_mask, 128, 256),
                   "comb_128x256": (cc.comb_mask, 128, 256)}[name]
    return maker(H, W)[None]


@pytest.mark.parametrize("W", [1, 7, 33, 320])
@pytest.mark.parametrize("h", list(_STRIP_H))
def test_strip_replay_at_strip_edges(h, W):
    """The strip cut stitches to the plain version bit for bit with the map
    one row high, one row short of a strip, exactly one strip, one row
    into the second strip and one row into the third."""
    H = _STRIP_H[h](cc.strip_rows(W))
    mask = np.random.default_rng(H * 1000 + W).random((2, H, W)) < 0.59
    got = _replay_strips(mask)
    assert torch.equal(got, cc.label_components_plain(torch.from_numpy(mask)))


@pytest.mark.parametrize("name", ["spiral_480x320", "comb_480x320", "spiral_128x256",
                                  "comb_128x256", "all_fg", "percolation", "checkerboard"])
def test_strip_replay_matches_plain(name):
    mask = _strip_case(name)
    got = _replay_strips(mask)
    assert torch.equal(got, cc.label_components_plain(torch.from_numpy(mask)))
    if name.startswith(("spiral", "comb", "all")):
        assert len(set(got.numpy()[mask].tolist())) == 1
    if name == "checkerboard":
        assert torch.equal(got.flatten(1)[0][mask.reshape(-1)],
                           torch.from_numpy(np.flatnonzero(mask)).int())


def test_strip_replay_batched_matches_pallas():
    """One batched case across two seams, also against the JAX package's
    serving path (Pallas in interpret mode, then its escalation)."""
    R = cc.strip_rows(7)
    mask = np.random.default_rng(3).random((2, 2 * R + 1, 7)) < 0.55
    got = _replay_strips(mask).numpy()
    ref = np.asarray(label_components_checked(
        jnp.asarray(mask), rounds=4, max_rounds=64, interpret=True))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, cc.label_components_plain(torch.from_numpy(mask)).numpy())


def test_strip_geometry_fits_shared_memory():
    """Every canvas bucket up to the 1280 cap (multiples of 64; score maps
    half that, up to 640x640) gets strips of whole rows, about
    ``STRIP_PIXELS`` pixels each, whose shared memory (the segment words, the
    mask bytes, the int32 parents and run roots) fits the budget; two blocks of that
    budget fit on an H100 SM (233,472 bytes, 1 KB reserved a block; 232,448
    at most a block)."""
    assert 2 * (cc.SMEM_BUDGET + 1024) <= 233472 and cc.SMEM_BUDGET <= 232448
    for canvas_w in range(64, 1281, 64):
        W = canvas_w // 2
        R, smem, threads, pixels, budget = cc.geometry(W)
        assert R == pixels // W >= 1 and threads == cc.STRIP_THREADS, (W, R)
        assert R * W <= pixels < (R + 1) * W
        assert 9 * R * W <= smem == cc.strip_smem(R, W) <= budget == cc.SMEM_BUDGET
    assert cc.strip_rows(1) == cc.STRIP_PIXELS  # a column map: one strip per 4096 rows
    wide = cc.STRIP_PIXELS * 2  # a strip of one row
    assert cc.strip_rows(wide) == 1 and cc.strip_smem(1, wide) <= cc.SMEM_BUDGET
    assert cc.strip_rows(cc.SMEM_BUDGET // 5) == 0  # no row fits: the wrapper raises
