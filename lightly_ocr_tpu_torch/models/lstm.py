"""Sequence model: two stacked BiLSTMs (port of ``models/lstm.py``).

Reference ``ocr/modules/biLSTM.py:9-33``: ``nn.LSTM(bidirectional=True,
batch_first=True)`` then a linear projection; the JAX package keeps torch's
parameter layout and gate order (i, f, g, o), so the tensors load as they are.
The LSTM and the projection run in the input's dtype on their parameters
cast to it (:class:`~lightly_ocr_tpu_torch.models.layers.LSTM`, ``Linear``).
"""
from __future__ import annotations

from torch import nn

from lightly_ocr_tpu_torch.models.layers import LSTM, Linear


class BidirectionalLSTM(nn.Module):
    def __init__(self, n_in: int, hidden: int, n_out: int):
        super().__init__()
        self.rnn = LSTM(n_in, hidden, bidirectional=True, batch_first=True)
        self.linear = Linear(2 * hidden, n_out)

    def forward(self, x):  # [B, T, n_in] -> [B, T, n_out]
        return self.linear(self.rnn(x)[0])


class SeqModeling(nn.ModuleList):
    def __init__(self, n_in: int, hidden: int):
        super().__init__([
            BidirectionalLSTM(n_in, hidden, hidden),
            BidirectionalLSTM(hidden, hidden, hidden),
        ])

    def forward(self, x):
        for m in self:
            x = m(x)
        return x
