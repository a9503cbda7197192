"""Every host sync of a greedy dispatch on the card sits in an ``ocr.sync``
span.

Marked ``cuda``; skips without a CUDA device.  Imports nothing of JAX, so
it runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_spans_cuda.py

A tiny bf16 ``tail,s2d`` BatchedOCR (kernels #5, #1 and the CC kernel on
the card) serves four receipts under ``torch.cuda.set_sync_debug_mode(
"warn")``, which warns at each synchronising call, while a CPU profiler
runs so that the program's spans open: each warning must come while an
``ocr.sync`` span is the innermost span open on its thread, and each such
span must see exactly one.  A warm b16 dispatch's ``prepare`` runs under
``set_sync_debug_mode("error")`` and gives the per-image formulation's
canvases and inverse ratios bit for bit and its gray within rounding.
"""
import threading
import traceback
import warnings

import numpy as np
import pytest
import torch

from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.layers import init_module
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.ops.image import LUMA, make_detector_input, plan_aspect_resize
from lightly_ocr_tpu_torch.serving.batch import BatchedOCR
from lightly_ocr_tpu_torch.utils.profiling import SYNC, trace

pytestmark = pytest.mark.cuda

TINY = dict(prediction="Attention", transform="TPS", output_channel=64, hidden_size=32,
            num_fiducial=8, max_boxes=4, character="abcdefghij", batch_max_len=8, attn_decode="greedy")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tiny_ocr(device) -> BatchedOCR:
    cfg = Config(**TINY)
    g = torch.Generator().manual_seed(0)
    det = init_module(VGG_UNet(), g).state_dict()
    rec = init_module(CRNNet(cfg), g).state_dict()
    return BatchedOCR(cfg, det, rec, boxes_per_image=8, dtype=torch.bfloat16, device=device)


def test_every_sync_of_a_greedy_dispatch_is_in_a_sync_span(cuda_device, monkeypatch, tmp_path):
    ocr = _tiny_ocr(cuda_device)
    rng = np.random.default_rng(0)
    images = [(rng.random((200, 160, 3)) * 255).astype(np.uint8) for _ in range(4)]
    ocr.run_images(images)  # builds the kernels and every shape
    torch.cuda.synchronize()

    local = threading.local()
    spans, stray = [], []
    real = torch.profiler.record_function

    class Tracked:
        def __init__(self, name):
            self.name, self.inner = name, real(name)

        def __enter__(self):
            local.__dict__.setdefault("open", []).append([self.name, 0])
            return self.inner.__enter__()

        def __exit__(self, *exc):
            spans.append(local.open.pop())
            return self.inner.__exit__(*exc)

    def on_warning(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        open_ = getattr(local, "open", [])
        if open_ and open_[-1][0] == SYNC:
            open_[-1][1] += 1
        else:
            stray.append("".join(traceback.format_stack(limit=8)))

    monkeypatch.setattr(torch.profiler, "record_function", Tracked)
    mode = torch.cuda.get_sync_debug_mode()
    with trace(str(tmp_path), cuda=False), warnings.catch_warnings():
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")  # a switch of the mode warns itself: not counted
        warnings.showwarning = on_warning
        try:
            out = ocr.run_images(images)
        finally:
            warnings.showwarning = lambda *a, **kw: None
            torch.cuda.set_sync_debug_mode(mode)
    assert len(out) == len(images)
    assert not stray, "syncs outside an ocr.sync span:\n" + "\n".join(stray)
    syncs = [n for name, n in spans if name == SYNC]
    print(f"{len(syncs)} host syncs in a greedy dispatch of {len(images)} receipts")
    assert syncs and all(n == 1 for n in syncs), syncs


@pytest.mark.parametrize("float_image", [False, True], ids=["uint8", "float"])
def test_prepare_of_a_b16_dispatch_never_blocks(cuda_device, float_image):
    """A warm b16 group of two sizes (a float image stages the group in
    float32) is prepared without a host sync, and its canvases equal the
    per-image formulation's (a float32 upload and ``make_detector_input``
    an image) bit for bit, its inverse ratios exactly and its gray (pads
    zero) within float32 rounding of the NumPy luma."""
    ocr = _tiny_ocr(cuda_device)
    rng = np.random.default_rng(1)
    images = ([(rng.random((200, 160, 3)) * 255).astype(np.uint8) for _ in range(10)]
              + [(rng.random((190, 150, 3)) * 255).astype(np.uint8) for _ in range(6)])
    if float_image:
        images[3] = rng.random((200, 160, 3)) * 255.0
    ((cb, gb), idxs), = ocr.group(images).items()
    assert len(idxs) == 16
    ocr.prepare(images, cb, gb)  # fills the constants and the pinned cache
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        canv, gray, inv_ratio, extents = ocr.prepare(images, cb, gb)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert canv.shape == (16, *cb, 3) and gray.shape == (16, *gb)
    gray = gray.cpu().numpy()
    for j, image in enumerate(images):
        h, w = image.shape[:2]
        plan = plan_aspect_resize(h, w, ocr.cfg.canvas_size, ocr.cfg.magnify_ratio, canvas_bucket=cb)
        img = np.asarray(image, np.float32)
        want = make_detector_input(torch.from_numpy(img).to(cuda_device), plan)
        assert torch.equal(canv[j], want), j
        assert extents[j].tolist() == [h, w]
        assert inv_ratio[j].item() == np.float32(1.0 / plan.ratio), j
        want_gray = np.zeros(gb, np.float32)
        want_gray[:h, :w] = img @ np.asarray(LUMA, np.float32)
        np.testing.assert_allclose(gray[j], want_gray, rtol=0, atol=1e-4, err_msg=str(j))
