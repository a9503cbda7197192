"""Sequence model: two stacked BiLSTMs (port of ``models/lstm.py``).

Reference ``ocr/modules/biLSTM.py:9-33``: ``nn.LSTM(bidirectional=True,
batch_first=True)`` then a linear projection; the JAX package keeps torch's
parameter layout and gate order (i, f, g, o), so the tensors load as they are.
"""
from __future__ import annotations

from torch import nn


class BidirectionalLSTM(nn.Module):
    def __init__(self, n_in: int, hidden: int, n_out: int):
        super().__init__()
        self.rnn = nn.LSTM(n_in, hidden, bidirectional=True, batch_first=True)
        self.linear = nn.Linear(2 * hidden, n_out)

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
