"""The port's per-image engines and their modules vs the JAX package.

``lightly_ocr_tpu_torch/engines.py`` (``CRAFT``, ``CRNN``) against
``lightly_ocr_tpu/engines.py`` on the same weights (made by the port's
seeded ``init_module``, read into the JAX trees by the JAX importer, and
carried back by ``state_dict_from_variables``), the same seeded receipts, in
float32 on the CPU, at a tiny recognizer width (the detector is VGG16 at
its one width): score maps to round-off, identical rects, equal texts,
confidences within 1e-4.  Also the modules the engines add to the port
(``ops/poly.py``, the ``cid`` output and ``boxes_to_rects`` of
``ops/detection.py``, ``ops/image.py``'s gray and recognizer resize,
``ops/ctc.py``, the CTC converter and head), the ``.pth`` loader, and the
port's batched CTC serving against the JAX ``BatchedOCR`` in CTC.

Thresholds come from quantiles of the JAX score maps so that several boxes
fire on random weights, and the recognizer heads are scaled so that the
random decoders emit varied strings.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_ocr_tpu.config import Config as JConfig
from lightly_ocr_tpu.engines import CRAFT as JCRAFT
from lightly_ocr_tpu.engines import CRNN as JCRNN
from lightly_ocr_tpu.models.crnn import CRNNet as JCRNNet
from lightly_ocr_tpu.models.vgg_unet import VGG_UNet as JVGG_UNet
from lightly_ocr_tpu.utils.torch_import import export_torch_state_dict, import_torch_state_dict
from lightly_ocr_tpu_torch import engines
from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.engines import CRAFT, CRNN
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.layers import init_module
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.weights import load_state_dict_file, state_dict_from_variables

from test_torch_slice import _receipt

_CFG = dict(output_channel=64, hidden_size=32, max_boxes=16, character="abcdefghij",
            batch_max_len=8, canvas_size=128, bucket_granularity=32)
HEADS = {"attn_tps": dict(prediction="Attention", transform="TPS"),
         "ctc_none": dict(prediction="CTC", transform="None")}


def jax_vars(module, args, state: dict) -> dict:
    """The JAX variables of ``module`` holding the port's ``state`` (the JAX
    importer on a zeros template; no JAX init is compiled)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args))
    tmpl = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    v = import_torch_state_dict(tmpl, {k: t.numpy() for k, t in state.items()})
    return jax.tree.map(np.asarray, v)


def detector_vars(seed: int = 0) -> dict:
    state = init_module(VGG_UNet(), torch.Generator().manual_seed(seed)).state_dict()
    return jax_vars(JVGG_UNet(), (jnp.zeros((1, 64, 64, 3)),), state)


def recognizer_vars(cfg: Config, seed: int = 1) -> dict:
    """Seeded recognizer weights with sharpened heads, so that the random
    decoders' strings vary with the crop: the CTC head scaled by 8; the
    attention cell's input weights and generator by 4 and the EOS logit
    raised by 1, so that some decodes end."""
    state = init_module(CRNNet(cfg), torch.Generator().manual_seed(seed)).state_dict()
    if cfg.prediction == "CTC":
        state["Prediction.weight"] *= 8.0
    else:
        state["Prediction.attention_cell.rnn.weight_ih"] *= 4.0
        state["Prediction.generator.weight"] *= 4.0
        state["Prediction.generator.bias"][1] += 1.0
    return jax_vars(JCRNNet(JConfig(**cfg.to_dict())),
                    (jnp.zeros((1, 32, 100, 1)), None, False), state)


@pytest.fixture(scope="module")
def setup():
    """Images, the tiny configs (thresholds from the JAX maps) and both
    packages' engines on the same weights."""
    rng = np.random.default_rng(0)
    images = [_receipt(rng, 80, 60), _receipt(rng, 72, 64)]
    dv = detector_vars()
    jdet = JCRAFT(JConfig(**_CFG), variables=dv)
    y, _ = jdet.score_maps(images[0])
    kw = {**_CFG, "low_text": float(np.quantile(y[..., 0], 0.75)),
          "text_threshold": float(np.quantile(y[..., 0], 0.9)),
          "link_threshold": float(np.quantile(y[..., 1], 0.97))}
    # the thresholds are read when detection first compiles, which is
    # after this: the compiled forward is kept
    jdet.cfg = JConfig(**kw)
    out = {"images": images, "kw": kw, "dv": dv, "jdet": jdet,
           "det": CRAFT(Config(**kw), state_dict=state_dict_from_variables(dv), device="cpu")}
    for name, head in HEADS.items():
        cfg = Config(**kw, **head)
        rv = recognizer_vars(cfg)
        out[name] = (JCRNN(JConfig(**kw, **head), variables=rv),
                     CRNN(cfg, state_dict=state_dict_from_variables(rv), device="cpu"), rv)
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_score_maps_and_rects_match_jax(setup, i):
    image = setup["images"][i]
    ref, ratio_ref = setup["jdet"].score_maps(image)
    got, ratio = setup["det"].score_maps(image)
    assert got.shape == ref.shape and ratio == ratio_ref
    # float32 round-off through VGG16's 20 conv layers
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5 * max(1.0, np.abs(ref).max()))
    want = setup["jdet"].detect_rects(image)
    rects = setup["det"].detect_rects(image)
    assert len(want) >= 3
    assert rects.dtype == np.int32
    np.testing.assert_array_equal(rects, np.asarray(want))
    crops = setup["det"].process(image)
    assert [c.shape for c in crops] == [c.shape for c in setup["jdet"].process(image)]


def test_detect_polygons_match_jax(setup):
    """``enable_poly=True``: the same boxes (float32 round-off) and the same
    polygon, or None, for each."""
    image = setup["images"][0]
    kw = {**setup["kw"], "enable_poly": True}
    jdet = JCRAFT(JConfig(**kw), variables=setup["dv"])
    # the JAX method applies its VGG eagerly, which compiles op by op; it
    # gets the engine's own compiled forward instead (same function)
    forward = setup["jdet"]._forward
    jdet.net = type("JittedNet", (), {"apply": staticmethod(lambda v, x: (forward(v, x[0])[None], None))})
    det = CRAFT(Config(**kw), state_dict=setup["det"].state_dict, device="cpu")
    jb, jp = jdet.detect_polygons(image)
    b, p = det.detect_polygons(image)
    assert len(b) == len(jb) >= 3 and len(p) == len(jp)
    np.testing.assert_allclose(b, np.asarray(jb), rtol=0, atol=1e-3)
    for got, want in zip(p, jp):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def _banana(H=80, W=220):
    """Region map of one curved word (``tests/test_poly.py``'s shape)."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    center = 40 + 12 * np.sin((xx - 10) / 60.0)
    return ((np.abs(yy - center) < 9) & (xx > 10) & (xx < W - 10)).astype(np.float32)


def test_cid_and_polygons_match_jax():
    """``get_det_boxes(return_cid=True)`` gives the JAX ``DetBoxes.cid``
    pixel for pixel, and the port's ``refine_polygons`` on it the JAX
    polygons: two curved words and a straight one (a 14-point polygon each
    for the curved, None for the straight)."""
    from lightly_ocr_tpu.ops.detection import get_det_boxes as jboxes
    from lightly_ocr_tpu.ops.poly import refine_polygons as jrefine
    from lightly_ocr_tpu_torch.ops.cc import label_components
    from lightly_ocr_tpu_torch.ops.detection import get_det_boxes
    from lightly_ocr_tpu_torch.ops.poly import refine_polygons

    tm = np.zeros((200, 240), np.float32)
    tm[:80, 10:230] = _banana() * 0.9
    tm[100:180, 10:230] = _banana()[:, ::-1] * 0.8
    tm[185:197, 20:120] = 0.9
    lm = np.zeros_like(tm)
    kw = dict(text_threshold=0.7, link_threshold=0.4, low_text=0.4, max_boxes=8)
    labels = label_components(torch.from_numpy(tm > 0.4))
    boxes, valid, cid = get_det_boxes(torch.from_numpy(tm)[None], torch.from_numpy(lm)[None],
                                      labels[None], return_cid=True, **kw)
    ref = jboxes(jnp.asarray(tm), jnp.asarray(lm), precomputed_labels=jnp.asarray(labels.numpy()), **kw)
    assert cid.shape == (1, 200, 240)
    np.testing.assert_array_equal(cid[0].numpy(), np.asarray(ref.cid))
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(ref.valid))
    assert valid.sum() == 3
    got = refine_polygons(boxes[0].numpy(), valid[0].numpy(), None, cid[0].numpy())
    want = jrefine(np.asarray(ref.boxes), np.asarray(ref.valid), None, np.asarray(ref.cid))
    assert [g is None for g in got] == [w is None for w in want] == [False, False, True]
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == (14, 2)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)


def test_boxes_to_rects_matches_jax():
    """Truncation after the x2 ratio, min/max per axis, row-major layout,
    zeros for invalid rows."""
    from lightly_ocr_tpu.ops.detection import boxes_to_rects as jrects
    from lightly_ocr_tpu_torch.ops.detection import boxes_to_rects

    rng = np.random.default_rng(5)
    boxes = (rng.random((6, 4, 2)) * 90).astype(np.float32)
    valid = np.asarray([True, True, False, True, True, False])
    for ratio in (1.0, 1 / 1.5, 0.7341):
        want = np.asarray(jrects(jnp.asarray(boxes), jnp.asarray(valid), ratio, ratio))
        got = boxes_to_rects(torch.from_numpy(boxes), torch.from_numpy(valid), ratio, ratio)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _patterns(H=80, W=120) -> np.ndarray:
    """A gray image of four bands (stripes, a ramp, a checkerboard, noise)
    whose crops the random recognizers read differently."""
    yy, xx = np.mgrid[0:H, 0:W]
    g = np.zeros((H, W), np.float32)
    g[:20] = ((xx[:20] // 3) % 2) * 255
    g[20:40] = xx[20:40] * 2
    g[40:60] = ((yy[40:60] // 2 + xx[40:60] // 5) % 2) * 255
    g[60:] = np.random.default_rng(0).random((20, W)) * 255
    return g


@pytest.mark.parametrize("shape", [(3, 30, 80), (2, 50, 300), (1, 32, 100), (2, 12, 40, 1)])
def test_resize_normalize_matches_jax(shape):
    """The per-crop recognizer feed (``CRNN.process``): PIL bicubic with
    antialias on downscales, saturated, in [-1, 1]."""
    from lightly_ocr_tpu.ops.image import resize_normalize as jresize
    from lightly_ocr_tpu_torch.ops.image import resize_normalize

    x = (np.random.default_rng(len(shape) * shape[2]).random(shape) * 255).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(x), 32, 100))
    got = resize_normalize(torch.from_numpy(x), 32, 100).numpy()
    assert got.shape == want.shape == (shape[0], 32, 100, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_sort_rects_matches_jax():
    from lightly_ocr_tpu.engines import compare_rects as jcompare
    from lightly_ocr_tpu.engines import sort_rects as jsort

    rng = np.random.default_rng(11)
    r0, c0 = rng.integers(0, 80, 40), rng.integers(0, 80, 40)
    rects = np.stack([r0, c0, r0 + rng.integers(1, 20, 40), c0 + rng.integers(1, 30, 40)], 1)
    rects[5] = rects[6]  # a tie
    np.testing.assert_array_equal(engines.sort_rects(rects), jsort(rects))
    assert [engines.compare_rects(a, b) for a in rects[:8] for b in rects[:8]] == \
        [jcompare(a, b) for a in rects[:8] for b in rects[:8]]
    assert len(engines.sort_rects(np.zeros((0, 4), np.int32))) == 0


@pytest.mark.parametrize("head", list(HEADS))
def test_crnn_matches_jax(setup, head):
    """``process_batch`` (bucketed, padded with degenerate rects),
    ``recognize_crops`` and the per-crop ``process``: equal texts,
    confidences within 1e-4."""
    from lightly_ocr_tpu.engines import gray_from_rgb as jgray

    jrec, rec, _ = setup[head]
    image = setup["images"][0]
    np.testing.assert_allclose(engines.gray_from_rgb(image), np.asarray(jgray(image)),
                               rtol=0, atol=1e-4)
    gray = _patterns()
    rects = np.asarray([[0, 0, 20, 120], [20, 0, 40, 120], [40, 0, 60, 120], [60, 0, 80, 120],
                        [0, 0, 80, 60], [10, 30, 70, 90]], np.int32)
    want, wconf = jrec.process_batch(gray, rects)
    texts, conf = rec.process_batch(gray, rects)
    assert texts == want and len(set(texts)) >= 3
    np.testing.assert_allclose(conf, np.asarray(wconf), rtol=0, atol=1e-4)
    none, none_conf = rec.process_batch(gray, rects[:0])
    assert none == [] and none_conf.shape == (0,)
    crop = (np.random.default_rng(2).random((18, 52)) * 255).astype(np.uint8)
    t_ref, res_ref = jrec.process({}, crop)
    t_got, res_got = rec.process({}, crop)
    assert t_got == t_ref
    np.testing.assert_allclose(list(res_got), list(res_ref), rtol=0, atol=1e-4)


def test_ctc_greedy_decode_and_converter_match_jax():
    from lightly_ocr_tpu.ops.ctc import ctc_greedy_decode as jdecode
    from lightly_ocr_tpu.text.converters import CTCLabelConverter as JConverter
    from lightly_ocr_tpu_torch.ops.ctc import ctc_greedy_decode
    from lightly_ocr_tpu_torch.text.converters import CTCLabelConverter, build_converter

    rng = np.random.default_rng(7)
    logits = rng.standard_normal((9, 26, 11)).astype(np.float32)
    logits[0, :, 0] += 10.0  # all blank
    logits[1, :, 3] += 10.0  # one repeated label
    want, wlen = jdecode(jnp.asarray(logits))
    got, glen = ctc_greedy_decode(torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
    conv, jconv = CTCLabelConverter("abcdefghij"), JConverter("abcdefghij")
    idx = logits.argmax(2)
    assert conv.decode_padded(idx) == jconv.decode_padded(idx)
    assert conv.decode_labels(got.numpy()) == jconv.decode_labels(np.asarray(want))
    assert conv.decode_labels(got.numpy(), glen.numpy()) == jconv.decode_labels(np.asarray(want), np.asarray(wlen))
    assert isinstance(build_converter("CTC", "ab"), CTCLabelConverter)
    with pytest.raises(ValueError):
        build_converter("Transformer", "ab")


def test_ctc_head_is_the_reference_linear(setup):
    """The CTC head is an ``nn.Linear`` named ``Prediction`` whose weight is
    the flax Dense kernel transposed (the 2D rule), one logit row a frame."""
    _, rec, rv = setup["ctc_none"]
    assert isinstance(rec.net.Prediction, torch.nn.Linear)
    np.testing.assert_array_equal(rec.net.Prediction.weight.detach().numpy(),
                                  rv["params"]["Prediction"]["kernel"].T)
    with torch.no_grad():
        got = rec.net(torch.zeros(3, 32, 100, 1))
    assert got.shape == (3, 26, 11)


def test_decode_refuses_what_is_not_ported():
    """Every decode mode is ported; what the port's decode still refuses is
    what the JAX package refuses: a CTC head asked for the attention beam or
    the attention prior, a CTC prior without the CTC beam, a non-zero blank,
    a beam narrower than 1 (each a ``ValueError`` there and here)."""
    from lightly_ocr_tpu_torch.models.attention import Attention
    from lightly_ocr_tpu_torch.models.decode import decode_crops
    from lightly_ocr_tpu_torch.ops.ctc import ctc_beam_search_decode

    ctc = Config(**_CFG, prediction="CTC", transform="None")
    net = CRNNet(ctc).eval()
    crops = torch.zeros(1, 32, 100, 1)
    with pytest.raises(ValueError, match="Attention head only"):
        net(crops, beam_width=4)
    with pytest.raises(ValueError, match="Attention head only"):
        net(crops, lm=torch.zeros(11, 11))
    with pytest.raises(ValueError, match="needs ctc_decode='beam'"):
        CRNN(ctc.replace(ctc_lm_path="prior.npy"), state_dict=net.state_dict(), device="cpu")
    with pytest.raises(ValueError, match="blank must be class 0"):
        ctc_beam_search_decode(torch.zeros(1, 4, 3), blank=1)
    with pytest.raises(ValueError, match=r"lm must be \[C, C\]"):
        ctc_beam_search_decode(torch.zeros(1, 4, 3), lm=torch.zeros(2, 2))
    with pytest.raises(ValueError, match="beam_width must be >= 1"):
        Attention(8, 8, 5, 3)(torch.zeros(1, 4, 8), beam_width=0)
    with torch.no_grad():  # the beam modes now decode
        idx, conf = decode_crops(net, crops, ctc.replace(ctc_decode="beam", beam_width=2))
    assert idx.shape == (1, 26) and conf.shape == (1,)


@pytest.mark.parametrize("prefix", ["", "module."])
def test_pth_round_trip_loads_strict(setup, tmp_path, prefix):
    """JAX ``export_torch_state_dict`` -> ``torch.save`` (with and without
    DataParallel's ``module.``) -> the port's engines with ``strict=True``,
    found in ``cfg.pretrained``: the weights arrive unchanged, the CTC
    head's Dense kernel transposed, and the engines read as before."""
    _, rec_ref, rv = setup["ctc_none"]
    for name, v in (("CRAFT.pth", setup["dv"]), ("CRNN.pth", rv)):
        sd = {prefix + k: torch.tensor(np.asarray(a)) for k, a in export_torch_state_dict(v).items()}
        torch.save(sd, tmp_path / name)
    cfg = Config(**setup["kw"], **HEADS["ctc_none"], pretrained=str(tmp_path))
    det, rec = CRAFT(cfg, device="cpu"), CRNN(cfg, device="cpu")
    for got, want in ((det, setup["det"]), (rec, rec_ref)):
        assert got.state_dict.keys() == want.state_dict.keys()
        for k, t in want.state_dict.items():
            assert torch.equal(got.state_dict[k], t), k
    assert torch.equal(rec.state_dict["Prediction.weight"],
                       torch.from_numpy(rv["params"]["Prediction"]["kernel"].T.copy()))
    image = setup["images"][1]
    np.testing.assert_array_equal(det.detect_rects(image), setup["det"].detect_rects(image))


def test_pth_loader_drops_only_recomputed_keys(tmp_path):
    """A reference checkpoint's bookkeeping (``num_batches_tracked``, the
    TPS grid constants) is dropped; any other extra key fails the strict
    load."""
    sd = init_module(VGG_UNet(), torch.Generator().manual_seed(3)).state_dict()
    extra = {**sd, "basenet.slice1.1.num_batches_tracked": torch.tensor(7),
             "Transformation.GridGenerator.P_hat": torch.zeros(3)}
    torch.save(extra, tmp_path / "ref.pth")
    loaded = load_state_dict_file(str(tmp_path / "ref.pth"))
    assert loaded.keys() == sd.keys()
    VGG_UNet().load_state_dict(loaded, strict=True)
    torch.save({**sd, "basenet.unknown.weight": torch.zeros(1)}, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        CRAFT(Config(**_CFG), model_path=str(tmp_path / "bad.pth"), device="cpu")


def test_missing_checkpoint_falls_back_to_seeded_weights(tmp_path, caplog):
    cfg = Config(**_CFG, **HEADS["ctc_none"], pretrained=str(tmp_path))
    with caplog.at_level(logging.WARNING, logger=engines.__name__):
        a = CRNN(cfg, seed=4, device="cpu")
    assert str(tmp_path / "CRNN.pth") in caplog.text
    b, c = CRNN(cfg, seed=4, device="cpu"), CRNN(cfg, seed=5, device="cpu")
    k = "Prediction.weight"
    assert torch.equal(a.state_dict[k], b.state_dict[k])
    assert not torch.equal(a.state_dict[k], c.state_dict[k])


def test_engines_refuse_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in (CRAFT, CRNN):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine(Config(**_CFG), state_dict={})


def test_batched_ctc_matches_jax_batched_ocr(setup):
    """The port's ``BatchedOCR`` with the CTC head (greedy collapse on the
    host) vs the JAX ``BatchedOCR`` in CTC, float32: equal texts and rects,
    confidences within 1e-4."""
    from lightly_ocr_tpu.serving.batch import BatchedOCR as JBatchedOCR
    from lightly_ocr_tpu_torch.serving.batch import BatchedOCR

    _, _, rv = setup["ctc_none"]
    kw = {**setup["kw"], **HEADS["ctc_none"]}
    images = setup["images"]
    ref = JBatchedOCR(JConfig(**kw), setup["dv"], rv, boxes_per_image=8,
                      dtype=jnp.float32).run_images(images)
    ocr = BatchedOCR(Config(**kw), setup["det"].state_dict, state_dict_from_variables(rv),
                     boxes_per_image=8, dtype=torch.float32, device="cpu")
    got = ocr.run_images(images)
    assert sum(len(r) for r in ref) >= 4
    assert len({it["text"] for r in ref for it in r}) >= 2
    for r_img, g_img in zip(ref, got):
        assert [g["text"] for g in g_img] == [r["text"] for r in r_img]
        assert [g["rect"] for g in g_img] == [r["rect"] for r in r_img]
        np.testing.assert_allclose([g["confidence"] for g in g_img],
                                   [r["confidence"] for r in r_img], rtol=0, atol=1e-4)


def test_batched_serve_model_builds_through_the_engines(setup, tmp_path):
    """``BatchedServeModel(config)`` reads ``CRAFT.pth``/``CRNN.pth`` through
    the per-image engines and serves their weights batched: the same answers
    as a ``BatchedOCR`` given those state dicts."""
    from lightly_ocr_tpu_torch.serving.batch import BatchedOCR
    from lightly_ocr_tpu_torch.serving.server import BatchedServeModel

    _, rec, _ = setup["ctc_none"]
    torch.save(setup["det"].state_dict, tmp_path / "CRAFT.pth")
    torch.save({"module." + k: t for k, t in rec.state_dict.items()}, tmp_path / "CRNN.pth")
    cfg = Config(**setup["kw"], **HEADS["ctc_none"], pretrained=str(tmp_path))
    model = BatchedServeModel(cfg, thresh=-1.0, boxes_per_image=8, device="cpu", dtype=torch.float32)
    assert isinstance(model.detector, CRAFT) and isinstance(model.recognizer, CRNN)
    for k, t in rec.state_dict.items():
        assert torch.equal(model.recognizer.state_dict[k], t), k
    ocr = BatchedOCR(cfg, setup["det"].state_dict, rec.state_dict, boxes_per_image=8,
                     dtype=torch.float32, device="cpu")
    image = setup["images"][:1]
    want = [[it["text"] for it in items] for items in ocr.run_images(image)]
    assert model.predict_many(image) == want and len(want[0]) >= 2
