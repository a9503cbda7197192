"""The port's batched serving slice as a whole vs the JAX ``BatchedOCR``.

On the CPU the JAX ``BatchedOCR`` runs the plain ``VGG_UNet`` and the XLA
labelling; the port runs its trunk + seam tail + CC wrappers, which take
their plain versions for CPU tensors.  Same weights (JAX init, exported),
same receipts (seeded numpy), float32, a tiny configuration: texts equal,
rects within 1 px, confidences within 0.05.  Thresholds are set from
quantiles of the JAX score maps so that several boxes fire, and the EOS
logit is shifted so that the random decoder emits strings that end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_ocr_tpu.config import Config as JConfig
from lightly_ocr_tpu.models.crnn import CRNNet as JCRNNet
from lightly_ocr_tpu.models.vgg_unet import VGG_UNet as JVGG_UNet
from lightly_ocr_tpu.ops.image import make_detector_input, pick_canvas_bucket, plan_aspect_resize
from lightly_ocr_tpu.serving.batch import BatchedOCR as JBatchedOCR
from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.serving.batch import BatchedOCR
from lightly_ocr_tpu_torch.serving.server import BatchedServeModel, InferenceWorker, QueueFullError
from lightly_ocr_tpu_torch.weights import state_dict_from_variables

_CFG = dict(prediction="Attention", transform="TPS", output_channel=64, hidden_size=32,
            max_boxes=8, character="abcdefghij", batch_max_len=8, canvas_size=128,
            bucket_granularity=32)


def _receipt(rng, h, w):
    g = np.full((h, w), 220.0)
    for _ in range(6):
        wh = int(rng.integers(8, max(9, h // 6)))
        ww = int(rng.integers(16, max(17, w // 2)))
        r = int(rng.integers(2, h - wh - 2))
        c = int(rng.integers(2, w - ww - 2))
        g[r:r + wh, c:c + ww] = rng.random((wh, ww)) * 90
    return np.stack([g, g, g], -1).astype(np.uint8)


@pytest.fixture(scope="module")
def slice_setup():
    rng = np.random.default_rng(0)
    images = [_receipt(rng, 80, 60), _receipt(rng, 70, 64), _receipt(rng, 90, 50)]
    dv = jax.tree.map(np.asarray, JVGG_UNet().init(jax.random.key(0), jnp.zeros((1, 64, 64, 3))))
    rv = jax.tree.map(np.asarray, JCRNNet(JConfig(**_CFG)).init(
        jax.random.key(1), jnp.zeros((2, 32, 100, 1)), None, False))
    gen = rv["params"]["Prediction"]["generator"]
    gen["kernel"] = gen["kernel"] * 8
    gen["bias"] = gen["bias"].copy()
    gen["bias"][1] -= 0.5  # EOS
    cb = pick_canvas_bucket(80, 60, 128, 1.5, granularity=32)
    plan = plan_aspect_resize(80, 60, 128, 1.5, canvas_bucket=cb)
    canvas, _ = make_detector_input(jnp.asarray(images[0], jnp.float32), plan)
    y = np.asarray(JVGG_UNet().apply(dv, canvas[None])[0])[0]
    thresholds = dict(low_text=float(np.quantile(y[..., 0], 0.75)),
                      text_threshold=float(np.quantile(y[..., 0], 0.9)),
                      link_threshold=float(np.quantile(y[..., 1], 0.97)))
    return images, dv, rv, {**_CFG, **thresholds}


def test_run_images_matches_jax_batched_ocr(slice_setup):
    images, dv, rv, kw = slice_setup
    ref = JBatchedOCR(JConfig(**kw), dv, rv, boxes_per_image=8,
                      dtype=jnp.float32).run_images(images)
    ocr = BatchedOCR(Config(**kw), state_dict_from_variables(dv), state_dict_from_variables(rv),
                     boxes_per_image=8, dtype=torch.float32, device="cpu")
    got = ocr.run_images(images)
    assert sum(len(r) for r in ref) >= 6  # several boxes fire
    assert any(it["text"] and it["confidence"] > 0 for r in ref for it in r)
    for r_img, g_img in zip(ref, got):
        assert len(g_img) == len(r_img)
        for r, g in zip(r_img, g_img):
            assert g["text"] == r["text"]
            assert abs(g["confidence"] - r["confidence"]) <= 0.05
            assert np.abs(np.asarray(g["rect"]) - np.asarray(r["rect"])).max() <= 1.0


def test_run_images_bf16_matches_jax_batched_ocr(slice_setup):
    """The served dtype end to end: the port's bf16 ``run_images`` (default
    plan: the s2d front, trunk, seam tail, CC) vs the JAX ``BatchedOCR`` in
    bf16 on the CPU (its plain bf16 detector), under the bf16 gate of the
    JAX package's own tests (``tests/test_quant.py``): score maps within
    0.02, identical boxes and transcripts, confidences within 0.05."""
    images, dv, rv, kw = slice_setup
    jocr = JBatchedOCR(JConfig(**kw), dv, rv, boxes_per_image=8, dtype=jnp.bfloat16)
    ref = jocr.run_images(images)
    ocr = BatchedOCR(Config(**kw), state_dict_from_variables(dv), state_dict_from_variables(rv),
                     boxes_per_image=8, dtype=torch.bfloat16, device="cpu")
    got = ocr.run_images(images)
    assert sum(len(r) for r in ref) >= 6
    for r_img, g_img in zip(ref, got):
        assert len(g_img) == len(r_img)
        for r, g in zip(r_img, g_img):
            assert g["text"] == r["text"]
            assert abs(g["confidence"] - r["confidence"]) <= 0.05
            assert g["rect"] == r["rect"]
    (cb, gb), idxs = next(iter(ocr.group(images).items()))
    canv = ocr.prepare([images[i] for i in idxs], cb, gb)[0]
    ys, _ = JVGG_UNet(dtype=jnp.bfloat16).apply(dv, jnp.asarray(canv.numpy()))
    with torch.no_grad():
        tm, lm = ocr.detector_scores(canv)
    got_s = torch.stack([tm, lm], -1).numpy()
    assert np.abs(got_s - np.asarray(ys, np.float32)).max() < 0.02


def test_run_images_int8_matches_jax_batched_ocr(slice_setup):
    """int8 serving (``quant_int8=True``, the default plan) vs the JAX
    ``BatchedOCR(quant_int8=True)`` on the CPU, under the int8 gates of
    ``tests/test_quant.py``: identical transcripts, rects within 4 px,
    confidences within 0.05.  (The ``cpool2`` plan also quantizes conv1_2
    and conv2_1, which the plain int8 detector keeps float, so it is a
    different function; ``test_torch_stem.py`` holds it to the JAX plan
    that runs it.)"""
    images, dv, rv, kw = slice_setup
    ref = JBatchedOCR(JConfig(**kw, quant_int8=True), dv, rv, boxes_per_image=8,
                      dtype=jnp.float32).run_images(images)
    ocr = BatchedOCR(Config(**kw, quant_int8=True),
                     state_dict_from_variables(dv), state_dict_from_variables(rv),
                     boxes_per_image=8, dtype=torch.float32, device="cpu")
    assert ocr.det_net.basenet.slice5["1"].quantized
    got = ocr.run_images(images)
    assert sum(len(r) for r in ref) >= 6
    for r_img, g_img in zip(ref, got):
        assert len(g_img) == len(r_img)
        for r, g in zip(r_img, g_img):
            assert g["text"] == r["text"]
            assert abs(g["confidence"] - r["confidence"]) <= 0.05
            assert np.abs(np.asarray(g["rect"]) - np.asarray(r["rect"])).max() <= 4.0


def test_serve_model_behind_worker(slice_setup):
    images, dv, rv, kw = slice_setup
    model = BatchedServeModel(Config(**kw), thresh=-1.0, boxes_per_image=8, device="cpu",
                              dtype=torch.float32, det_state=state_dict_from_variables(dv),
                              rec_state=state_dict_from_variables(rv))
    direct = model.ocr.run_images(images)
    worker = InferenceWorker(model.predict_many, max_batch=4, max_queue=0)
    try:
        answers = [f.result(timeout=120) for f in [worker.submit(im) for im in images]]
    finally:
        worker.close()
    assert not worker.thread.is_alive()
    assert answers == [[it["text"] for it in items] for items in direct]


def test_worker_sheds_load_when_queue_full():
    import threading

    gate = threading.Event()
    worker = InferenceWorker(lambda imgs: (gate.wait(10), [None] * len(imgs))[1],
                             max_batch=1, max_queue=1)
    try:
        first = worker.submit(np.zeros((2, 2, 3), np.uint8))
        deadline = 50
        while worker.q.qsize() and deadline:  # let the loop pick it up
            deadline -= 1
            threading.Event().wait(0.05)
        worker.submit(np.zeros((2, 2, 3), np.uint8))
        with pytest.raises(QueueFullError):
            worker.submit(np.zeros((2, 2, 3), np.uint8))
    finally:
        gate.set()
        first.result(timeout=10)
        worker.close()
    assert not worker.thread.is_alive()


def test_entry_points_refuse_a_missing_gpu(monkeypatch):
    """Built without ``device=`` the entry points want the card; with no GPU
    they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(**_CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedServeModel(cfg, det_state={}, rec_state={})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedOCR(cfg, {}, {})


def test_vectorised_decode_equals_per_box_converter():
    """``BatchedOCR.decode`` == the converter's own decode of every valid
    box, including rows that emit [GO] before EOS and rows without EOS."""
    from lightly_ocr_tpu_torch.models.crnn import CRNNet
    from lightly_ocr_tpu_torch.models.layers import init_module
    from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet

    cfg = Config(**_CFG)
    g = torch.Generator().manual_seed(0)
    ocr = BatchedOCR(cfg, init_module(VGG_UNet(), g).state_dict(),
                     init_module(CRNNet(cfg), g).state_dict(),
                     boxes_per_image=4, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, cfg.derived_num_classes, (2, 4, cfg.num_steps)))
    idx[0, 0, :3] = torch.tensor([5, 0, 1])  # [GO] before EOS
    idx[0, 1] = 4  # no EOS
    out = {"valid": torch.tensor([[True, True, False, True], [False, True, True, True]]),
           "pred_idx": idx, "confidence": torch.rand(2, 4),
           "rects": torch.rand(2, 4, 4) * 50}
    res = ocr.decode(out)
    for b in range(2):
        want = [m for m in range(4) if out["valid"][b, m]]
        assert [it["text"] for it in res[b]] == [
            ocr.converter.decode_trimmed(idx[b, m][None].numpy())[0] for m in want]
        assert [it["rect"] for it in res[b]] == [out["rects"][b, m].tolist() for m in want]
