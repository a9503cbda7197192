"""The port's beam decoding and LM prior vs the JAX package (float32, CPU).

* ``ops/ctc.py::ctc_beam_search_decode`` against the JAX function on seeded
  logits (beam widths 1, 4 and 8, with and without a prior, and a beam wider
  than the classes): every live beam (score > -1e29) has equal labels and
  lengths, scores within 1e-4; and against brute-force enumeration of all
  alignments at C = 3, T = 5 (``tests/test_beam_search.py``'s method),
  within 1e-5 relative.
* ``models/attention.py``: the beam against the JAX ``Attention(...,
  beam_width=W)`` with the same weights (``weights.py``), tokens equal and
  scores within 1e-4; greedy fusion, fused logits within 1e-5 and equal
  argmax.
* ``models/decode.py``: ``lm_prior_to_attention_space`` to 1e-6;
  ``load_lm_prior``'s ``ValueError``s for the same configs.
* Wiring: the engines (CTC beam + prior, attention beam + prior) and one
  ``BatchedOCR`` dispatch per head, texts equal and confidences within
  1e-4 in float32.  The JAX ``BatchedOCR``'s recognizer branch is run as
  its pieces (``decode_crops`` on the JAX crops of the same rects, then
  ``BatchedOCR.decode``), which compiles the recognizer only.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_ocr_tpu.config import Config as JConfig
from lightly_ocr_tpu.engines import CRNN as JCRNN
from lightly_ocr_tpu.models.attention import Attention as JAttention
from lightly_ocr_tpu.models.decode import decode_crops as jdecode_crops
from lightly_ocr_tpu.models.decode import lm_prior_to_attention_space as jto_attention
from lightly_ocr_tpu.models.decode import load_lm_prior as jload_lm_prior
from lightly_ocr_tpu.ops.crop import crop_resize_normalize_matmul as jcrop
from lightly_ocr_tpu.ops.ctc import ctc_beam_search_decode
from lightly_ocr_tpu.serving.batch import BatchedOCR as JBatchedOCR
from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.engines import CRNN
from lightly_ocr_tpu_torch.models.attention import Attention
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.decode import lm_prior_to_attention_space, load_lm_prior
from lightly_ocr_tpu_torch.models.layers import init_module
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.ops import ctc
from lightly_ocr_tpu_torch.serving.batch import BatchedOCR
from lightly_ocr_tpu_torch.weights import state_dict_from_variables

from test_torch_engines import _patterns, recognizer_vars
from test_torch_slice import _receipt

_CFG = dict(output_channel=64, hidden_size=32, character="abcdefghij", batch_max_len=8)
# jitted: one compile a case, not one per eager op
jctc_beam = jax.jit(ctc_beam_search_decode, static_argnames=("beam_width",))
HEADS = {"ctc": dict(prediction="CTC", transform="None", ctc_decode="beam"),
         "attn": dict(prediction="Attention", transform="TPS", attn_decode="beam")}


def _prior(n: int, seed: int) -> np.ndarray:
    """A charset-space [n+1, n+1] log-prior (row-normalised, weight 0.6)."""
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(n + 1), size=n + 1)
    return (0.6 * np.log(p)).astype(np.float32)


def _live_equal(ref, got, atol):
    labels, lengths, scores = (np.asarray(a) for a in ref)
    g_labels, g_lengths, g_scores = (a.numpy() for a in got)
    live = scores > -1e29
    assert live.any()
    np.testing.assert_array_equal(g_scores > -1e29, live)
    np.testing.assert_array_equal(g_labels[live], labels[live])
    np.testing.assert_array_equal(g_lengths[live], lengths[live])
    np.testing.assert_allclose(g_scores[live], scores[live], rtol=0, atol=atol)


@pytest.mark.parametrize("W", [1, 4, 8])
@pytest.mark.parametrize("with_lm", [False, True], ids=["plain", "lm"])
def test_ctc_beam_matches_jax(W, with_lm):
    B, T, C = 4, 26, 11
    rng = np.random.default_rng(W + 10 * with_lm)
    logits = (4.0 * rng.standard_normal((B, T, C))).astype(np.float32)
    lm = (1.5 * rng.standard_normal((C, C))).astype(np.float32) if with_lm else None
    ref = jctc_beam(jnp.asarray(logits), beam_width=W, lm=None if lm is None else jnp.asarray(lm))
    got = ctc.ctc_beam_search_decode(torch.from_numpy(logits), beam_width=W,
                                 lm=None if lm is None else torch.from_numpy(lm))
    assert got[0].shape == (B, W, T)
    _live_equal(ref, got, 1e-4)


def test_ctc_beam_wider_than_classes_matches_jax():
    """W > C, and more slots than prefixes (one label over 10 frames has
    6): dead slots stay dead (junk hashes) and never double-count."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 10, 2)).astype(np.float32)
    lm = rng.standard_normal((2, 2)).astype(np.float32)
    ref = jctc_beam(jnp.asarray(logits), beam_width=9, lm=jnp.asarray(lm))
    got = ctc.ctc_beam_search_decode(torch.from_numpy(logits), beam_width=9, lm=torch.from_numpy(lm))
    _live_equal(ref, got, 1e-4)
    assert (got[2].numpy() < -1e29).any()  # some slots are dead


def _brute_force(logp: np.ndarray, lm=None) -> dict:
    """Exact log P(collapsed string) (+ the prior once per extension) by
    enumerating all C^T paths."""
    T, C = logp.shape
    out: dict = {}
    for path in itertools.product(range(C), repeat=T):
        lp = float(sum(logp[t, c] for t, c in enumerate(path)))
        key, prev = [], -1
        for c in path:
            if c != 0 and c != prev:
                key.append(c)
            prev = c
        out[tuple(key)] = float(np.logaddexp(out.get(tuple(key), -np.inf), lp))
    if lm is not None:
        for key in out:
            last = 0
            for c in key:
                out[key] += float(lm[last, c])
                last = c
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_lm", [False, True], ids=["plain", "lm"])
def test_ctc_beam_exact_against_brute_force(seed, with_lm):
    """W = 64 covers every prefix of 5 frames over 2 labels (63), so no
    pruning: each live beam scores its exact (fused) posterior."""
    T, C = 5, 3
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((1, T, C))).astype(np.float32)
    lm = (1.5 * rng.standard_normal((C, C))).astype(np.float32) if with_lm else None
    logp = torch.log_softmax(torch.from_numpy(logits)[0].double(), -1).numpy()
    exact = _brute_force(logp, lm)
    labels, lengths, scores = ctc.ctc_beam_search_decode(
        torch.from_numpy(logits), beam_width=64, lm=None if lm is None else torch.from_numpy(lm))
    live = scores[0] > -1e29
    assert int(live.sum()) == len(exact)
    for w in np.nonzero(live.numpy())[0]:
        key = tuple(labels[0, w, :lengths[0, w]].tolist())
        np.testing.assert_allclose(scores[0, w].item(), exact[key], rtol=1e-5)
    best = max(exact, key=exact.get)
    assert tuple(labels[0, 0, :lengths[0, 0]].tolist()) == best


def _attention_pair(C, H=16, T=7, S=6, seed=0):
    """The JAX ``Attention`` and the port's with the same weights (scaled
    so that the decode varies)."""
    jm = JAttention(hidden=H, num_classes=C, num_steps=S)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((3, T, H)).astype(np.float32)
    v = jm.init(jax.random.key(seed), jnp.asarray(feats), jnp.zeros((3, S), jnp.int32), True)
    v = jax.tree.map(lambda a: 3.0 * np.asarray(a), v)
    m = Attention(H, H, C, S)
    m.load_state_dict(state_dict_from_variables(v), strict=True)
    return jm, v, m.eval(), feats


@pytest.mark.parametrize("W,C", [(1, 7), (4, 7), (8, 5)], ids=["w1", "w4", "w8_wider_than_classes"])
@pytest.mark.parametrize("with_lm", [False, True], ids=["plain", "lm"])
def test_attention_beam_matches_jax(W, C, with_lm):
    jm, v, m, feats = _attention_pair(C, seed=W)
    lm = np.random.default_rng(W).standard_normal((C, C)).astype(np.float32) if with_lm else None
    jt, js = jax.jit(lambda f, p: jm.apply(v, f, None, False, W, p))(
        jnp.asarray(feats), None if lm is None else jnp.asarray(lm))
    with torch.no_grad():
        tokens, scores = m(torch.from_numpy(feats), W, None if lm is None else torch.from_numpy(lm))
    assert tokens.shape == (3, W, 6) and scores.dtype == torch.float32
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jt))
    js = np.asarray(js)
    live = js > -1e29
    np.testing.assert_allclose(scores.numpy()[live], js[live], rtol=0, atol=1e-4)


def test_attention_greedy_fusion_matches_jax():
    C = 7
    jm, v, m, feats = _attention_pair(C, seed=3)
    lm = np.random.default_rng(3).standard_normal((C, C)).astype(np.float32)
    lm[0, 2] = -1e9  # a veto on one first token
    ref = np.asarray(jax.jit(lambda f, p: jm.apply(v, f, None, False, None, p))(
        jnp.asarray(feats), jnp.asarray(lm)))
    with torch.no_grad():
        got = m(torch.from_numpy(feats), None, torch.from_numpy(lm)).numpy()
        plain = m(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    assert not np.array_equal(got.argmax(-1), plain.argmax(-1))  # the prior steers


def test_lm_prior_to_attention_space_matches_jax():
    arr = _prior(10, 0)
    np.testing.assert_allclose(lm_prior_to_attention_space(arr), jto_attention(arr),
                               rtol=0, atol=1e-6)
    assert lm_prior_to_attention_space(arr).dtype == np.float32


_BAD_PRIORS = {
    "ctc_greedy": (dict(prediction="CTC"), (11, 11)),
    "ctc_beam_shape": (dict(prediction="CTC", ctc_decode="beam"), (2, 2)),
    "attn_shape": (dict(prediction="Attention"), (12, 12)),
}


@pytest.mark.parametrize("case", list(_BAD_PRIORS))
def test_load_lm_prior_refuses_as_jax(case, tmp_path):
    kw, shape = _BAD_PRIORS[case]
    path = str(tmp_path / "prior.npy")
    np.save(path, np.zeros(shape, np.float32))
    with pytest.raises(ValueError) as want:
        jload_lm_prior(JConfig(**_CFG, **kw, ctc_lm_path=path))
    with pytest.raises(ValueError) as got:
        load_lm_prior(Config(**_CFG, **kw, ctc_lm_path=path))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("head", ["ctc", "attn"])
def test_load_lm_prior_matches_jax(head, tmp_path):
    path = str(tmp_path / "prior.npy")
    np.save(path, _prior(10, 1))
    kw = {**_CFG, **HEADS[head], "ctc_lm_path": path}
    got = load_lm_prior(Config(**kw))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(jload_lm_prior(JConfig(**kw))), rtol=0, atol=1e-6)
    assert load_lm_prior(Config(**_CFG)) is None


@pytest.fixture(scope="module")
def heads(tmp_path_factory):
    """Per head: the tiny beam config with a seeded prior, and the
    recognizer weights (JAX tree, sharpened heads) of ``test_torch_engines``,
    the attention head's EOS logit without the +1 that its greedy decode
    needs (else every beam stops at once)."""
    path = str(tmp_path_factory.mktemp("prior") / "prior.npy")
    np.save(path, _prior(len(_CFG["character"]), 2))
    out = {}
    for name, head in HEADS.items():
        cfg = Config(**_CFG, **head, beam_width=4, ctc_lm_path=path)
        rv = recognizer_vars(cfg)
        if name == "attn":
            gen = rv["params"]["Prediction"]["generator"]
            gen["bias"] = gen["bias"] - np.eye(1, len(gen["bias"]), 1, np.float32)[0]
        out[name] = (cfg, rv)
    return out


@pytest.mark.parametrize("head", list(HEADS))
def test_engine_beam_with_prior_matches_jax(heads, head):
    """``process_batch`` on the bands of ``test_torch_engines._patterns``."""
    cfg, rv = heads[head]
    gray = _patterns()
    rects = np.asarray([[0, 0, 20, 120], [20, 0, 40, 120], [40, 0, 60, 120], [60, 0, 80, 120],
                        [0, 0, 80, 60], [10, 30, 70, 90]], np.int32)
    want, wconf = JCRNN(JConfig(**cfg.to_dict()), variables=rv).process_batch(gray, rects)
    rec = CRNN(cfg, state_dict=state_dict_from_variables(rv), device="cpu")
    assert rec.lm is not None
    texts, conf = rec.process_batch(gray, rects)
    assert texts == want and len(set(texts)) >= 2
    np.testing.assert_allclose(conf, np.asarray(wconf), rtol=0, atol=1e-4)


@pytest.mark.parametrize("head", list(HEADS))
def test_batched_ocr_beam_with_prior_matches_jax(heads, head):
    """One ``BatchedOCR`` dispatch with the beam and the prior: its
    recognizer output and host decode against the JAX ``decode_crops`` on
    the same rects and the JAX ``BatchedOCR.decode``."""
    cfg, rv = heads[head]
    rng = np.random.default_rng(0)
    images = [_receipt(rng, 80, 60), _receipt(rng, 72, 64)]
    det_sd = init_module(VGG_UNet(), torch.Generator().manual_seed(0)).state_dict()
    probe = BatchedOCR(cfg, det_sd, state_dict_from_variables(rv), boxes_per_image=8,
                       dtype=torch.float32, device="cpu")
    (cb, gb), idxs = next(iter(probe.group(images).items()))
    args = probe.prepare([images[i] for i in idxs], cb, gb)
    with torch.no_grad():
        tm, lm = probe.detector_scores(args[0])
    cfg = cfg.replace(low_text=float(torch.quantile(tm, 0.75)),
                      text_threshold=float(torch.quantile(tm, 0.9)),
                      link_threshold=float(torch.quantile(lm, 0.97)))
    ocr = BatchedOCR(cfg, det_sd, state_dict_from_variables(rv), boxes_per_image=8,
                     dtype=torch.float32, device="cpu")
    out = ocr(*args)
    assert int(out["valid"].sum()) >= 4
    B, M = out["valid"].shape
    jcfg = JConfig(**cfg.to_dict())
    jocr = JBatchedOCR(jcfg, {}, rv, boxes_per_image=8, dtype=jnp.float32)
    lm_j = jload_lm_prior(jcfg)

    @jax.jit
    def recognize(gray, rects):  # the JAX BatchedOCR program's steps 4-5
        crops = jax.vmap(lambda g, r: jcrop(g, r, cfg.height, cfg.width, "cubic"))(gray, rects)
        return jdecode_crops(jocr.rec_net, rv, crops.reshape(-1, cfg.height, cfg.width, 1),
                             jcfg, lm_j)

    idx, conf = recognize(jnp.asarray(args[1].numpy()), jnp.asarray(out["rects"].numpy()))
    np.testing.assert_array_equal(out["pred_idx"].numpy(), np.asarray(idx).reshape(B, M, -1))
    np.testing.assert_allclose(out["confidence"].numpy(), np.asarray(conf).reshape(B, M),
                               rtol=0, atol=1e-4)
    ref = jocr.decode({"valid": out["valid"].numpy(), "pred_idx": np.asarray(idx).reshape(B, M, -1),
                       "confidence": np.asarray(conf).reshape(B, M), "rects": out["rects"].numpy()})
    got = ocr.decode(out)
    assert [[it["text"] for it in r] for r in got] == [[it["text"] for it in r] for r in ref]
    assert len({it["text"] for r in got for it in r}) >= 2
    for g_img, r_img in zip(got, ref):
        np.testing.assert_allclose([g["confidence"] for g in g_img],
                                   [r["confidence"] for r in r_img], rtol=0, atol=1e-4)


def test_ctc_beam_host_decode_keeps_double_letters():
    """Beam labels are final: ``aa`` stays ``aa`` in the engine's and the
    batched decode (the greedy collapse would give ``a``)."""
    cfg = Config(**_CFG, **HEADS["ctc"])
    g = torch.Generator().manual_seed(0)
    rec = CRNN(cfg, state_dict=init_module(CRNNet(cfg), g).state_dict(), device="cpu")
    a = cfg.character.index("a") + 1  # CTC label (0 is the blank)
    labels = np.array([[a, a, 0, 0], [a, 0, 0, 0]])
    assert rec.decode(labels) == ["aa", "a"]
    ocr = BatchedOCR(cfg, init_module(VGG_UNet(), g).state_dict(), rec.state_dict,
                     boxes_per_image=2, dtype=torch.float32, device="cpu")
    out = {"valid": torch.ones(1, 2, dtype=torch.bool), "pred_idx": torch.from_numpy(labels)[None],
           "confidence": torch.ones(1, 2), "rects": torch.zeros(1, 2, 4)}
    assert [it["text"] for it in ocr.decode(out)[0]] == ["aa", "a"]
