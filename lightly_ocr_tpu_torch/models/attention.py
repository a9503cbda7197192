"""Bahdanau attention decoder, greedy (port of ``models/attention.py``).

Per step, as ``AttentionCell`` (reference ``ocr/modules/attention.py:
38-88``): ``e = score(tanh(i2h(feats) + h2h(h)))``, ``alpha = softmax_T(e)``,
``context = alpha^T feats``, ``LSTMCell([context; onehot(prev)], (h, c))``,
``logits = generator(h)``, and the argmax feeds the next step.  ``i2h(feats)``
is step-invariant and computed once.  Beam search and the LM prior are not
ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class AttentionCell(nn.Module):
    def __init__(self, n_in: int, hidden: int, num_classes: int):
        super().__init__()
        self.i2h = nn.Linear(n_in, hidden, bias=False)
        self.h2h = nn.Linear(hidden, hidden)
        self.score = nn.Linear(hidden, 1, bias=False)
        self.rnn = nn.LSTMCell(n_in + num_classes, hidden)


class Attention(nn.Module):
    def __init__(self, n_in: int, hidden: int, num_classes: int,
                 num_steps: int = 26):
        super().__init__()
        self.hidden, self.num_classes, self.num_steps = hidden, num_classes, num_steps
        self.attention_cell = AttentionCell(n_in, hidden, num_classes)
        self.generator = nn.Linear(hidden, num_classes)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, T, n_in] -> greedy-decode logits [B, num_steps, classes]."""
        cell = self.attention_cell
        B = feats.shape[0]
        proj = cell.i2h(feats)
        h = feats.new_zeros(B, self.hidden)
        c = feats.new_zeros(B, self.hidden)
        prev = torch.zeros(B, dtype=torch.long, device=feats.device)  # [GO]
        out = []
        for _ in range(self.num_steps):
            e = cell.score(torch.tanh(proj + cell.h2h(h)[:, None, :]))
            alpha = torch.softmax(e, dim=1)
            context = (alpha * feats).sum(1)
            onehot = F.one_hot(prev, self.num_classes).to(feats.dtype)
            h, c = cell.rnn(torch.cat([context, onehot], 1), (h, c))
            logits = self.generator(h)
            prev = logits.argmax(1)
            out.append(logits)
        return torch.stack(out, 1)
