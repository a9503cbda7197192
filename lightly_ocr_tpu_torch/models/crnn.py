"""CRNN recognizer: TPS -> ResNet -> BiLSTM x2 -> attention (port).

Port of ``lightly_ocr_tpu/models/crnn.py`` (reference ``ocr/model.py:
64-118``) for the slice the serving path runs: ``transform`` None or TPS,
``sequence`` None or biLSTM, ``prediction="Attention"`` with greedy decode.
``quant=True`` runs the ResNet's convs as w8a8 :class:`QuantConv`; TPS,
BiLSTM and attention stay float, as in the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn

from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.models.attention import Attention
from lightly_ocr_tpu_torch.models.lstm import SeqModeling
from lightly_ocr_tpu_torch.models.resnet import ResNet50v2
from lightly_ocr_tpu_torch.models.tps import TPS_STN


class CRNNet(nn.Module):
    def __init__(self, cfg: Config, quant: bool = False):
        super().__init__()
        if cfg.prediction != "Attention":
            raise NotImplementedError(
                "the port has the Attention head only; CTC is not ported yet"
            )
        self.cfg = cfg
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
        self.Prediction = Attention(n, cfg.hidden_size, cfg.derived_num_classes,
                                    cfg.num_steps)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] in [-1, 1] -> greedy logits [B, num_steps, classes]."""
        p = next(self.parameters())
        x = images.permute(0, 3, 1, 2).to(p.dtype)
        if self.Transformation is not None:
            x = self.Transformation(x)
        x = self.FeatureExtraction(x)  # [B, C, H', W']
        x = x.mean(dim=2).transpose(1, 2)  # mean over H -> [B, W', C]
        if self.SequenceModeling is not None:
            x = self.SequenceModeling(x)
        return self.Prediction(x)
