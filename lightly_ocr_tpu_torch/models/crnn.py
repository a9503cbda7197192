"""CRNN recognizer: TPS -> ResNet -> BiLSTM x2 -> CTC or attention (port).

Port of ``lightly_ocr_tpu/models/crnn.py`` (reference ``ocr/model.py:
64-118``): ``transform`` None or TPS, ``sequence`` None or biLSTM,
``prediction`` CTC (a linear head named ``Prediction``, so its
``weight``/``bias`` keys are the reference's) or Attention (in ``train()``
teacher-forced on ``text``; in ``eval()`` greedy or beam decode, with an
optional LM prior).  A ``quant=True`` model refuses a forward that could
train it (``train()`` mode with gradients on), as the JAX package does.
``quant=True`` runs the ResNet's convs as w8a8 :class:`QuantConv`; TPS,
BiLSTM and the heads stay float, as in the JAX package.  ``dtype`` is the
compute dtype on float32 parameters (the JAX model's ``dtype``,
:func:`~lightly_ocr_tpu_torch.models.layers.compute_dtype`); the TPS
computes its grid in float32 whatever it is.
"""
from __future__ import annotations

import torch
from torch import nn

from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.models.attention import Attention
from lightly_ocr_tpu_torch.models.layers import Linear, compute_dtype, init_train_params
from lightly_ocr_tpu_torch.models.lstm import SeqModeling
from lightly_ocr_tpu_torch.models.resnet import ResNet50v2
from lightly_ocr_tpu_torch.models.tps import TPS_STN
from lightly_ocr_tpu_torch.utils.profiling import annotate


class CRNNet(nn.Module):
    def __init__(self, cfg: Config, quant: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.quant = quant
        self.dtype = dtype
        cin = cfg.derived_input_channel
        self.Transformation = (
            TPS_STN(cfg.num_fiducial, cfg.height, cfg.width, cin)
            if cfg.transform == "TPS" else None
        )
        self.FeatureExtraction = ResNet50v2(cin, cfg.output_channel, quant)
        n = cfg.output_channel
        self.SequenceModeling = None
        if cfg.sequence == "biLSTM":
            self.SequenceModeling = SeqModeling(n, cfg.hidden_size)
            n = cfg.hidden_size
        if cfg.prediction == "CTC":
            self.Prediction = Linear(n, cfg.derived_num_classes)
        else:
            self.Prediction = Attention(n, cfg.hidden_size, cfg.derived_num_classes,
                                        cfg.num_steps)

    def forward(self, images: torch.Tensor, text: torch.Tensor | None = None,
                beam_width: int | None = None, lm: torch.Tensor | None = None):
        """[B, H, W, C] in [-1, 1] -> logits: per frame [B, W', classes]
        (CTC), or [B, num_steps, classes] of the attention head: teacher
        forced on ``text`` in ``train()``, else the greedy decode (in
        ``eval()`` ``text`` is not read); with
        ``beam_width`` (Attention only) the beam's (tokens, scores).  ``lm``
        is the Attention head's shallow-fusion prior; the CTC prior is fused
        in ``ops.ctc.ctc_beam_search_decode`` over the logits."""
        if self.cfg.prediction == "CTC":
            if beam_width is not None:
                raise ValueError(
                    "beam_width applies to the Attention head only; "
                    "CTC beam search is ops.ctc.ctc_beam_search_decode "
                    "over the logits"
                )
            if lm is not None:
                raise ValueError(
                    "lm applies to the Attention head only; the CTC "
                    "prior is fused inside ctc_beam_search_decode"
                )
        if self.quant and self.training and torch.is_grad_enabled():
            raise ValueError(
                "quant=True is an inference-only mode: QuantConv's rounding "
                "has zero gradient, so training would silently freeze every "
                "backbone conv.  Train in float and enable quant_int8 only "
                "for serving (call .eval() to serve)."
            )
        x = images.permute(0, 3, 1, 2).to(compute_dtype(self))
        if self.Transformation is not None:
            x = self.Transformation(x)
        with annotate("crnn.features"):
            x = self.FeatureExtraction(x)  # [B, C, H', W']
        x = x.mean(dim=2).transpose(1, 2)  # mean over H -> [B, W', C]
        if self.SequenceModeling is not None:
            x = self.SequenceModeling(x)
        with annotate("crnn.prediction"):
            if self.cfg.prediction == "CTC":
                return self.Prediction(x)
            return self.Prediction(x, beam_width, lm, text=text)


def init_crnn(cfg: Config, seed: int, dtype: torch.dtype = torch.float32,
              device="cuda") -> CRNNet:
    """A :class:`CRNNet` computing in ``dtype`` on float32 parameters,
    with flax's seeded initialisation (:func:`~lightly_ocr_tpu_torch.
    models.layers.init_train_params`), on ``device`` (the card unless the
    caller asks for the CPU; raises without one): the JAX package's
    ``init_crnn``, whose model and variables are this one module."""
    from lightly_ocr_tpu_torch.serving.batch import resolve_device

    model = init_train_params(CRNNet(cfg, dtype=dtype), torch.Generator().manual_seed(int(seed)))
    return model.to(resolve_device(device))
