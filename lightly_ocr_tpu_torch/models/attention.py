"""Bahdanau attention decoder: teacher forcing for training; greedy, greedy
with an LM prior, and beam search for inference (port of
``lightly_ocr_tpu/models/attention.py``).

Per step, as ``AttentionCell`` (reference ``ocr/modules/attention.py:
38-88``): ``e = score(tanh(i2h(feats) + h2h(h)))``, ``alpha = softmax_T(e)``,
``context = alpha^T feats``, ``LSTMCell([context; onehot(prev)], (h, c))``,
``logits = generator(h)``; in training the next step is fed the
ground-truth token, in inference the argmax.  ``i2h(feats)``
is step-invariant and computed once.  The JAX package runs these loops in
XLA (no Pallas kernel), so stock PyTorch ops serve here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lightly_ocr_tpu_torch.models.layers import Linear, LSTMCell

_NEG = -1.0e30
_EOS = 1


class AttentionCell(nn.Module):
    def __init__(self, n_in: int, hidden: int, num_classes: int):
        super().__init__()
        self.i2h = Linear(n_in, hidden, bias=False)
        self.h2h = Linear(hidden, hidden)
        self.score = Linear(hidden, 1, bias=False)
        self.rnn = LSTMCell(n_in + num_classes, hidden)

    def lstm_cell(self, feats: torch.Tensor):
        """The LSTM cell as a function for one decode over ``feats``, its
        weights cast to ``feats``' dtype once for all the steps
        (:meth:`~lightly_ocr_tpu_torch.models.layers.LSTMCell.cast`); a
        cell whose weights are split over a model axis gathers them here,
        once (:class:`~lightly_ocr_tpu_torch.parallel.tensor.
        ShardedLSTMCell`)."""
        gathered = getattr(self.rnn, "gathered", None)
        return self.rnn.cast(feats) if gathered is None else gathered()

    def step(self, feats, proj, h, c, prev, num_classes: int, rnn):
        """One decode step for states ``h``, ``c`` [..., H] attending over
        ``feats``/``proj`` [..., T, n_in/H] (broadcast over leading dims)
        with previous tokens ``prev`` [...] -> new (h, c); ``rnn`` is
        :meth:`lstm_cell`'s function."""
        e = self.score(torch.tanh(proj + self.h2h(h)[..., None, :]))
        context = (torch.softmax(e, dim=-2) * feats).sum(-2)
        onehot = F.one_hot(prev, num_classes).to(feats.dtype)
        lead = h.shape[:-1]
        x = torch.cat([context, onehot], -1).reshape(-1, context.shape[-1] + num_classes)
        h, c = rnn(x, (h.reshape(-1, h.shape[-1]), c.reshape(-1, c.shape[-1])))
        return h.reshape(*lead, -1), c.reshape(*lead, -1)


class Attention(nn.Module):
    def __init__(self, n_in: int, hidden: int, num_classes: int,
                 num_steps: int = 26):
        super().__init__()
        self.hidden, self.num_classes, self.num_steps = hidden, num_classes, num_steps
        self.attention_cell = AttentionCell(n_in, hidden, num_classes)
        self.generator = Linear(hidden, num_classes)

    def forward(self, feats: torch.Tensor, beam_width: int | None = None,
                lm: torch.Tensor | None = None, text: torch.Tensor | None = None):
        """[B, T, n_in] encoder states ->

        * training (``self.training`` and ``text`` given): teacher forcing
          on ``text`` [B, >= num_steps] ([GO]-prefixed): step s is fed
          ``one_hot(text[:, s])``; logits [B, num_steps, classes] of
          ``generator`` over the hidden states (``attention.py:122-142`` of
          the JAX package); ``lm`` is refused there;
        * greedy: logits [B, num_steps, classes] of the argmax-fed decode;
          with ``lm`` (a [classes, classes] log-prior in attention index
          space), ``lm[prev]`` is added to each step's float32 logits before
          the argmax feedback and in the emitted scores;
        * ``beam_width`` W: (tokens [B, W, num_steps], scores [B, W] float32),
          best-first, as :meth:`_beam_decode`.
        """
        if self.training and text is not None:
            return self._teacher_forced(feats, text, lm)
        if beam_width is not None:
            return self._beam_decode(feats, int(beam_width), lm)
        cell = self.attention_cell
        B = feats.shape[0]
        proj, rnn = cell.i2h(feats), cell.lstm_cell(feats)
        h = feats.new_zeros(B, self.hidden)
        c = feats.new_zeros(B, self.hidden)
        prev = torch.zeros(B, dtype=torch.long, device=feats.device)  # [GO]
        out = []
        for _ in range(self.num_steps):
            h, c = cell.step(feats, proj, h, c, prev, self.num_classes, rnn)
            logits = self.generator(h)
            if lm is not None:  # fused scores, emitted and fed back
                logits = logits.float() + lm[prev]
            prev = logits.argmax(1)
            out.append(logits)
        return torch.stack(out, 1)

    def _teacher_forced(self, feats, text, lm=None):
        if lm is not None:
            raise ValueError("lm fusion is inference-only")
        cell = self.attention_cell
        B = feats.shape[0]
        proj, rnn = cell.i2h(feats), cell.lstm_cell(feats)
        h = feats.new_zeros(B, self.hidden)
        c = feats.new_zeros(B, self.hidden)
        hs = []
        for s in range(self.num_steps):
            h, c = cell.step(feats, proj, h, c, text[:, s].long(), self.num_classes, rnn)
            hs.append(h)
        return self.generator(torch.stack(hs, 1))

    def _beam_decode(self, feats, W: int, lm=None):
        """Beam search over the decode (``attention.py:172-263`` of the JAX
        package).  ``scores`` = sum of token log-probs up to and including
        the first EOS (index 1): a beam that has emitted EOS may only emit
        EOS, at cost 0, and the last step forces EOS on every live beam at
        its true log-prob, so ``exp(score)`` is a sequence probability.
        ``lm`` is added to the per-extension log-probs.  The W beams ride
        along the batch as [B, W, ...] states against the [B, 1, T, ...]
        encoder states; logits and log-probs are float32, the LSTM state in
        the net's dtype.  Ties in the top-W go to the lower index, as
        ``lax.top_k`` breaks them."""
        if W < 1:
            raise ValueError(f"beam_width must be >= 1, got {W}")
        cell = self.attention_cell
        B = feats.shape[0]
        C, S, H = self.num_classes, self.num_steps, self.hidden
        dev = feats.device
        feats1 = feats[:, None]  # [B, 1, T, n_in]
        proj1, rnn = cell.i2h(feats)[:, None], cell.lstm_cell(feats)
        h = feats.new_zeros(B, W, H)
        c = feats.new_zeros(B, W, H)
        prev = torch.zeros((B, W), dtype=torch.long, device=dev)  # [GO]
        score = torch.full((B, W), _NEG, device=dev)
        score[:, 0] = 0.0
        fin = torch.zeros((B, W), dtype=torch.bool, device=dev)
        seqs = torch.zeros((B, W, S), dtype=torch.long, device=dev)
        eos_only = torch.where(torch.arange(C, device=dev) == _EOS, 0.0, _NEG)
        for s in range(S):
            h2, c2 = cell.step(feats1, proj1, h, c, prev, C, rnn)
            logp = F.log_softmax(self.generator(h2).float(), dim=-1)  # [B, W, C]
            if lm is not None:
                logp = logp + lm[prev]
            step_lp = torch.where(fin[..., None], eos_only, logp)
            if s == S - 1:  # live beams terminate, paying their EOS log-prob
                step_lp = step_lp + eos_only
            cand = (score[..., None] + step_lp).reshape(B, W * C)
            score, pos = torch.sort(cand, dim=1, descending=True, stable=True)
            score, pos = score[:, :W], pos[:, :W]
            parent, tok = pos // C, pos % C
            h = h2.gather(1, parent[..., None].expand(B, W, H))
            c = c2.gather(1, parent[..., None].expand(B, W, H))
            fin = fin.gather(1, parent) | (tok == _EOS)
            seqs = seqs.gather(1, parent[..., None].expand(B, W, S))
            seqs[:, :, s] = tok
            prev = tok
        return seqs, score
