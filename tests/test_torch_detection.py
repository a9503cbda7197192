"""Box extraction and crops of the PyTorch port vs the JAX package.

``ops/detection.py::get_det_boxes`` (batched) against the JAX
``get_det_boxes`` per image with the same labels, and
``ops/crop.py::crop_resize_normalize_matmul`` against its JAX counterpart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from lightly_ocr_tpu.ops.crop import crop_resize_normalize_matmul as jcrop
from lightly_ocr_tpu.ops.detection import get_det_boxes as jboxes
from lightly_ocr_tpu_torch.ops.cc import label_components
from lightly_ocr_tpu_torch.ops.crop import crop_resize_normalize_matmul
from lightly_ocr_tpu_torch.ops.detection import get_det_boxes


def _maps(rng, B, H, W, sigma):
    def smooth():
        m = ndimage.gaussian_filter(rng.random((B, H, W)), (0, sigma, sigma))
        lo = m.min(axis=(1, 2), keepdims=True)
        hi = m.max(axis=(1, 2), keepdims=True)
        return ((m - lo) / (hi - lo)).astype(np.float32)

    return smooth(), smooth()


# (B, H, W, max_boxes): H >= 64 with 8*K <= 32*H takes the two-level
# root extraction, the others the flat sort
@pytest.mark.parametrize("B,H,W,K,sigma", [(3, 96, 128, 16, 2.0), (2, 32, 48, 8, 1.5),
                                           (2, 64, 96, 64, 1.0)])
def test_boxes_and_valid_equal_jax(B, H, W, K, sigma):
    rng = np.random.default_rng(H * W + K)
    tm, lm = _maps(rng, B, H, W, sigma)
    kw = dict(text_threshold=0.7, link_threshold=0.65, low_text=0.55, max_boxes=K)
    fg = (tm > kw["low_text"]) | (lm > kw["link_threshold"])
    labels = label_components(torch.from_numpy(fg))
    boxes, valid = get_det_boxes(torch.from_numpy(tm), torch.from_numpy(lm), labels, **kw)
    assert boxes.shape == (B, K, 4, 2) and valid.shape == (B, K)
    assert valid.any()
    for b in range(B):
        ref = jboxes(jnp.asarray(tm[b]), jnp.asarray(lm[b]),
                     precomputed_labels=jnp.asarray(labels[b].numpy()), **kw)
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(ref.valid))
        # the same float32 arithmetic; cos/sin and fused multiply-adds of
        # the two libraries may differ in the last bit
        np.testing.assert_allclose(boxes[b].numpy(), np.asarray(ref.boxes), rtol=0, atol=1e-3)


def test_candidate_cap_keeps_scan_order():
    """More components than 2*max_boxes: both keep the same first ones."""
    H, W, K = 64, 64, 4
    tm = np.zeros((1, H, W), np.float32)
    for r in range(2, H - 4, 6):
        for c in range(2, W - 4, 6):
            tm[0, r:r + 3, c:c + 4] = 0.9
    lm = np.zeros_like(tm)
    kw = dict(text_threshold=0.7, link_threshold=0.4, low_text=0.4, max_boxes=K)
    labels = label_components(torch.from_numpy(tm > 0.4))
    boxes, valid = get_det_boxes(torch.from_numpy(tm), torch.from_numpy(lm), labels, **kw)
    ref = jboxes(jnp.asarray(tm[0]), jnp.asarray(lm[0]),
                 precomputed_labels=jnp.asarray(labels[0].numpy()), **kw)
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(boxes[0].numpy(), np.asarray(ref.boxes), rtol=0, atol=1e-3)


def test_crop_matches_jax():
    rng = np.random.default_rng(9)
    B, M, H0, W0 = 2, 5, 96, 128
    gray = (rng.random((B, H0, W0)) * 255).astype(np.float32)
    r0 = rng.integers(0, H0 - 8, (B, M))
    c0 = rng.integers(0, W0 - 8, (B, M))
    rects = np.stack([r0, c0, r0 + rng.integers(2, 60, (B, M)),
                      c0 + rng.integers(2, 120, (B, M))], -1).astype(np.float32)
    rects[..., 2] = np.minimum(rects[..., 2], H0)
    rects[..., 3] = np.minimum(rects[..., 3], W0)
    rects[0, 0] = (0, 0, 1, 1)  # the dummy rect of an invalid slot
    got = crop_resize_normalize_matmul(torch.from_numpy(gray), torch.from_numpy(rects), 32, 100)
    assert got.shape == (B, M, 32, 100, 1)
    for b in range(B):
        ref = jcrop(jnp.asarray(gray[b]), jnp.asarray(rects[b]), 32, 100, "cubic")
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), rtol=0, atol=1e-4)
