"""The plain reference against the program on the CPU at tiny sizes, in
float32: the two compute the same functions (the check on the card holds
the program's bf16 serving and float32 training to the reference)."""
import numpy as np
import pytest
import torch

from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.data.loader import align_collate
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.ops.cc import label_components
from lightly_ocr_tpu_torch.ops.crop import crop_resize_normalize_matmul
from lightly_ocr_tpu_torch.ops.detection import get_det_boxes
from lightly_ocr_tpu_torch.ops.image import make_detector_input, pick_canvas_bucket, plan_aspect_resize
from ocr_bench import gen, serving
from ocr_bench.reference import boxes, craft, crnn, prep, words

CFG = Config(output_channel=32, hidden_size=16)


@pytest.fixture(scope="module")
def sds():
    torch.manual_seed(0)
    return serving.make_weights(CFG, 123, torch.device("cpu"))


def test_detector(sds):
    m = VGG_UNet().eval()
    m.load_state_dict(sds[0], strict=True)
    x = torch.randn(2, 64, 96, 3)
    with torch.no_grad():
        a, b = m(x)[0], craft.forward(sds[0], x)
    assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def test_recognizer_teacher_forced_on_its_greedy_tokens(sds):
    r = CRNNet(CFG).eval()
    r.load_state_dict(sds[1], strict=True)
    imgs = torch.rand(5, 32, 100, 1) * 2 - 1
    with torch.no_grad():
        logits = r(imgs)
        idx = logits.argmax(-1)
        fed = torch.cat([torch.zeros_like(idx[:, :1]), idx[:, :-1]], 1)
        ref = crnn.CRNN(sds[1], serving.rec_cfg(CFG)).forced_logits(imgs, fed)
    assert (logits - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_canvas_and_crop():
    img = gen.receipts(np.random.default_rng(2), 1, 120, 80)[0]
    cfgd = {"canvas_size": 1280, "magnify_ratio": 1.5, "bucket_granularity": 64}
    canv, ratio = prep.detector_canvas(img, cfgd, "cpu")
    cb = pick_canvas_bucket(120, 80, 1280, 1.5, granularity=64)
    plan = plan_aspect_resize(120, 80, 1280, 1.5, canvas_bucket=cb)
    want = make_detector_input(torch.from_numpy(img).float(), plan)
    assert canv.shape == want.shape and ratio == plan.ratio
    assert (canv - want).abs().max() < 1e-4
    gray = prep.gray(img, "cpu")
    rects = torch.tensor([[[10.0, 5.0, 40.0, 70.0], [3.0, 2.0, 9.0, 8.0]]])
    got = crop_resize_normalize_matmul(gray[None], rects, 32, 100)[0]
    for r, g in zip(rects[0].tolist(), got):
        assert (prep.crop(gray, r, 32, 100) - g).abs().max() < 1e-4


def test_boxes():
    rng = np.random.default_rng(4)
    H, W = 96, 128
    region = np.zeros((H, W), np.float32)
    link = np.zeros((H, W), np.float32)
    for _ in range(12):
        r, c = rng.integers(4, H - 12), rng.integers(4, W - 30)
        region[r:r + rng.integers(4, 9), c:c + rng.integers(8, 25)] = rng.uniform(0.5, 1.0)
    link[40:44, 10:100] = 0.6
    t, lk = torch.from_numpy(region)[None], torch.from_numpy(link)[None]
    labels = label_components((t > 0.4) | (lk > 0.4))
    got, valid = get_det_boxes(t, lk, labels, 0.7, 0.4, 0.4, max_boxes=32)
    got = [b.numpy() for b, v in zip(got[0], valid[0]) if v]
    ref = boxes.det_boxes(region, link, 0.7, 0.4, 0.4, 32)
    assert len(got) == len(ref) > 3
    g_rects = boxes.rects(got, 0.75, 2 * H, 2 * W)
    r_rects = boxes.rects(ref, 0.75, 2 * H, 2 * W)
    assert boxes.unmatched(g_rects, r_rects, at=0.95) == 0


def test_word_images():
    font = gen.glyph_font("abc", 1)
    rng = np.random.default_rng(1)
    imgs = [gen.word_image(t, font, rng) for t in ("abc", "abcabcabcab", "cab")]
    got, _ = align_collate([(i, "x") for i in imgs], 32, 100, keep_ratio=True)
    for i, g in zip(imgs, got):
        assert np.abs(words.keep_ratio_image(i, 32, 100) - g[..., 0]).max() * 127.5 <= 1.0 + 1e-4
