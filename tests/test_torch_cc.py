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
