"""Decode of the recognizer's heads: crops/logits -> (indices, confidence).

Port of ``lightly_ocr_tpu/models/decode.py``: one implementation of the
decode modes, used by the per-image engine (``engines.CRNN``) and the
batched serving program (``serving/batch.BatchedOCR``).

Greedy (reference ``ocr/net.py:165-193``): argmax tokens, and
* CTC: the product of the per-frame maximum probabilities over all frames
  (the host collapses repeats and blanks, ``CTCLabelConverter``);
* Attention: the product of the per-step maximum probabilities strictly
  before the first EOS (index 1), 0 when no EOS appears.

Beam (beyond the reference):
* CTC: :func:`~lightly_ocr_tpu_torch.ops.ctc.ctc_beam_search_decode`; the
  indices are final label sequences (the host must not collapse them
  again), the confidence is the sequence posterior; an optional [C, C]
  shallow-fusion log-prior ``lm`` is added per extension;
* Attention: ``Attention._beam_decode``; every beam ends in EOS, the
  confidence is exp(sequence log-prob including EOS).

The prior (``cfg.ctc_lm_path``, :func:`load_lm_prior`) steers the Attention
head's greedy decode from inside its loop, and both beams.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.ops.ctc import ctc_beam_search_decode


def lm_prior_to_attention_space(arr: np.ndarray) -> np.ndarray:
    """A charset-space [n+1, n+1] transition log-prior (row/col 0 = word
    start / blank, i+1 = the i-th charset char; the layout of
    ``scripts/build_lm_prior.py``) -> attention index space [n+2, n+2]
    ([GO]=0, [s]=1, chars at 2+): [GO] takes the word-start row, char rows
    and columns shift by one, and the EOS row and column stay 0, so the
    prior reranks characters and never the stop decision.  Each row's char
    entries are centred (mean 0): raw log-priors are all negative while the
    EOS column sits at 0, and uncentred rows would make every extension pay
    a penalty that stopping does not (a length bias toward early EOS)."""
    n = arr.shape[0] - 1
    out = np.zeros((n + 2, n + 2), np.float64)
    out[0, 2:] = arr[0, 1:] - np.mean(arr[0, 1:])
    out[2:, 2:] = arr[1:, 1:] - np.mean(arr[1:, 1:], axis=1, keepdims=True)
    return out.astype(arr.dtype)


def load_lm_prior(cfg: Config, device="cpu") -> torch.Tensor | None:
    """The shallow-fusion prior named by ``cfg.ctc_lm_path`` (a ``.npy``
    charset-space [n+1, n+1] float array of log-priors, any fusion weight
    folded in) as a float32 tensor on ``device``; None for an empty path.
    CTC needs ``ctc_decode="beam"`` and takes the array as it is (CTC labels
    are the charset space); the Attention head takes it in greedy and beam
    decode, remapped by :func:`lm_prior_to_attention_space`."""
    if not cfg.ctc_lm_path:
        return None
    if cfg.prediction == "CTC" and cfg.ctc_decode != "beam":
        raise ValueError(
            "with prediction='CTC' the LM prior needs ctc_decode='beam' "
            f"(got ctc_decode={cfg.ctc_decode!r}); the Attention head "
            "accepts it in greedy and beam modes"
        )
    arr = np.load(os.path.expanduser(cfg.ctc_lm_path))
    n = len(cfg.character)
    if arr.shape != (n + 1, n + 1):
        raise ValueError(
            f"LM prior at {cfg.ctc_lm_path!r} must be charset-space "
            f"[n+1, n+1] = {(n + 1, n + 1)}, got {arr.shape}"
        )
    if cfg.prediction != "CTC":
        arr = lm_prior_to_attention_space(np.asarray(arr))
    return torch.as_tensor(np.asarray(arr, np.float32), device=device)


def decode_preds(preds: torch.Tensor, cfg: Config, lm: torch.Tensor | None = None):
    """[K, T, C] logits -> (idx [K, T] int64, confidence [K] f32) per
    ``cfg``'s decode mode; ``lm`` reaches the CTC beam only."""
    preds = preds.float()
    if cfg.prediction == "CTC" and cfg.ctc_decode == "beam":
        labels, _, scores = ctc_beam_search_decode(preds, beam_width=cfg.beam_width, lm=lm)
        return labels[:, 0], torch.exp(scores[:, 0])
    max_probs = torch.softmax(preds, dim=2).amax(2)
    idx = preds.argmax(2)
    if cfg.prediction == "CTC":
        return idx, max_probs.prod(1)
    eos = idx == 1
    before_eos = torch.cumsum(eos, dim=1) == 0
    conf = torch.where(before_eos, max_probs, 1.0).prod(1)
    conf = torch.where(eos.any(1), conf, 0.0)
    return idx, conf


def decode_crops(net, crops: torch.Tensor, cfg: Config, lm: torch.Tensor | None = None):
    """[K, H, W, 1] normalized crops -> (idx [K, S], confidence [K]): the
    recognizer ``net`` and the decode of ``cfg``."""
    if cfg.prediction != "CTC" and cfg.attn_decode == "beam":
        tokens, scores = net(crops, beam_width=cfg.beam_width, lm=lm)
        return tokens[:, 0], torch.exp(scores[:, 0].float())
    if cfg.prediction != "CTC" and lm is not None:
        # greedy fusion runs inside the decode loop: the prior steers the
        # fed-back token, not only the readout
        return decode_preds(net(crops, lm=lm), cfg)
    return decode_preds(net(crops), cfg, lm)
