"""The port's ``BatchedOCR.prepare`` on the CPU: one staged upload a group,
held to the per-image formulation it replaced (a float32 cast on the host,
``make_detector_input`` an image, the NumPy luma, pad rows left zero)."""
import time

import numpy as np
import pytest
import torch

from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.layers import init_module
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.ops.image import LUMA, make_detector_input, plan_aspect_resize
from lightly_ocr_tpu_torch.serving.batch import BatchedOCR
from lightly_ocr_tpu_torch.utils.profiling import counter_values


def _per_image_prepare(ocr, images, cb, gb):
    """The port's prep one image at a time: a float32 cast on the host,
    one ``make_detector_input`` an image, the NumPy luma, pad rows left
    zero."""
    cfg = ocr.cfg
    B = 1 << (len(images) - 1).bit_length()
    canv = torch.zeros((B, *cb, 3))
    grays = np.zeros((B, *gb), np.float32)
    inv_ratios = np.ones((B,), np.float32)
    extents = np.ones((B, 2), np.float32)
    for j, image in enumerate(images):
        img = np.asarray(image, np.float32)
        h, w = img.shape[:2]
        plan = plan_aspect_resize(h, w, cfg.canvas_size, cfg.magnify_ratio, canvas_bucket=cb)
        canv[j] = make_detector_input(torch.from_numpy(img), plan)
        grays[j, :h, :w] = img @ np.asarray(LUMA, np.float32)
        inv_ratios[j] = 1.0 / plan.ratio
        extents[j] = (float(h), float(w))
    return canv.numpy(), grays, inv_ratios, extents


@pytest.fixture(scope="module")
def torch_ocr():
    """The port's BatchedOCR of seeded weights at a tiny width, on the CPU."""
    cfg = Config(prediction="CTC", transform="None", output_channel=32, hidden_size=16,
                 max_boxes=4, character="abcdefghij", canvas_size=128,
                 bucket_granularity=64, gray_granularity=128)
    g = torch.Generator().manual_seed(0)
    det = init_module(VGG_UNet(), g).state_dict()
    rec = init_module(CRNNet(cfg), g).state_dict()
    return BatchedOCR(cfg, det, rec, boxes_per_image=4, device="cpu")


@pytest.mark.parametrize("kinds, runs", [
    # two adjacent images of one size, one of another: 3 rows into B=4
    (("u8 48x64", "u8 48x64", "u8 50x60"), [1, 2]),
    # the same with a float image of the first size after them
    (("u8 48x64", "u8 48x64", "u8 50x60", "f64 48x64"), [1, 1, 2]),
], ids=["uint8_padded", "with_float"])
def test_torch_prepare_equals_per_image(torch_ocr, rng, kinds, runs):
    """The port's ``BatchedOCR.prepare`` (one staged upload, a resize a run
    of one size) gives the per-image formulation's canvases, ratios and
    extents exactly, its gray up to float32 rounding of the sum order, and
    leaves pad rows zero."""
    images = []
    for kind in kinds:
        dtype, size = kind.split()
        h, w = map(int, size.split("x"))
        if dtype == "u8":
            images.append(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        else:
            images.append(rng.random((h, w, 3)) * 255.0)
    ((cb, gb), idxs), = torch_ocr.group(images).items()  # one group
    assert idxs == list(range(len(images)))
    since = time.perf_counter()
    canv, gray, inv_ratio, extents = torch_ocr.prepare(images, cb, gb)
    assert sorted(counter_values("ocr.prepare.resize_batch", since)) == runs
    want_canv, want_gray, want_inv, want_ext = _per_image_prepare(torch_ocr, images, cb, gb)
    n, B = len(images), want_canv.shape[0]
    assert canv.shape == (B, *cb, 3) and gray.shape == (B, *gb)
    assert inv_ratio.shape == (B,) and extents.shape == (B, 2)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in (canv, gray, inv_ratio, extents))
    np.testing.assert_array_equal(canv.numpy(), want_canv)
    assert not canv[n:].any() and not gray[n:].any()
    np.testing.assert_array_equal(inv_ratio.numpy(), want_inv)
    np.testing.assert_array_equal(extents.numpy(), want_ext)
    np.testing.assert_allclose(gray.numpy(), want_gray, rtol=0, atol=1e-4)
