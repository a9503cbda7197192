"""Greedy decode of the recognizer's heads: crops -> (indices, confidence).

Port of ``lightly_ocr_tpu/models/decode.py::decode_crops``/``decode_preds``
in greedy mode (reference ``ocr/net.py:165-193``); argmax tokens, and

* CTC: the product of the per-frame maximum probabilities over all frames
  (the host collapses repeats and blanks, ``CTCLabelConverter``);
* Attention: the product of the per-step maximum probabilities strictly
  before the first EOS (index 1), 0 when no EOS appears.

CTC beam search, the attention beam and the LM prior are not ported yet.
"""
from __future__ import annotations

import torch

from lightly_ocr_tpu_torch.config import Config


def decode_preds(preds: torch.Tensor, cfg: Config):
    """[K, T, C] logits -> (idx [K, T] int64, confidence [K] f32)."""
    beam = cfg.ctc_decode if cfg.prediction == "CTC" else cfg.attn_decode
    if beam != "greedy" or cfg.ctc_lm_path:
        raise NotImplementedError("the port decodes greedily, without an LM prior, only")
    preds = preds.float()
    max_probs = torch.softmax(preds, dim=2).amax(2)
    idx = preds.argmax(2)
    if cfg.prediction == "CTC":
        return idx, max_probs.prod(1)
    eos = idx == 1
    before_eos = torch.cumsum(eos, dim=1) == 0
    conf = torch.where(before_eos, max_probs, 1.0).prod(1)
    conf = torch.where(eos.any(1), conf, 0.0)
    return idx, conf


def decode_crops(net, crops: torch.Tensor, cfg: Config):
    """[K, H, W, 1] normalized crops -> (idx [K, S], confidence [K])."""
    return decode_preds(net(crops), cfg)
