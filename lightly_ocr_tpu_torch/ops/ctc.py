"""CTC on the device: the training losses, greedy (best path) and prefix
beam search decoding.

Port of ``lightly_ocr_tpu/ops/ctc.py`` (``ctc_loss``,
``ctc_forward_logprob``, ``cross_entropy_ignore_index``,
``ctc_greedy_decode``, ``ctc_beam_search_decode``).  The JAX package
computes all of them in XLA (no Pallas kernel), so stock PyTorch ops serve
here: the loss is ``F.ctc_loss``, whose forward equals the JAX package's
log-semiring recursion to round-off.  On log-probabilities narrower than
float32 (a bfloat16 step) it is that recursion itself, in their dtype, as
XLA runs the JAX package's (:func:`_ctc_forward_reduced`): ``F.ctc_loss``
takes float32 and float64 only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_NEG_INF = -1.0e30  # finite -inf stand-in: keeps logsumexp NaN-free
_MASK32 = 0xFFFFFFFF
# the JAX package's 32-bit rolling-hash pair: multipliers, and the junk
# hashes that keep dead slots from merging with live prefixes (initial
# slots, and slots the top-W pads with non-representatives)
_P, _P2 = 1000003, 1000033
_INIT = ((0x9E3779B9, 12345), (0x27D4EB2F, 54321))
_DEAD = ((0x85EBCA6B, 0xC2B2AE35), (0x165667B1, 0x7F4A7C15))


def _logsumexp2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(exp(a) + exp(b)), exactly ``_NEG_INF`` when both are ~-inf."""
    m = torch.maximum(a, b)
    finite = m > 0.5 * _NEG_INF
    m_safe = torch.where(finite, m, 0.0)
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe)
    return torch.where(finite, m_safe + torch.log(torch.where(finite, s, 1.0)), _NEG_INF)


def ctc_forward_logprob(log_probs: torch.Tensor, labels: torch.Tensor,
                        input_lengths: torch.Tensor, label_lengths: torch.Tensor) -> torch.Tensor:
    """Per-sample log P(labels | log_probs), [B]: ``log_probs`` [B, T, C]
    log-softmax outputs (class 0 the blank), ``labels`` [B, L] padded (the
    padding is masked by ``label_lengths``).  ``-inf`` where no alignment
    exists (the JAX package returns ~-1e30 there)."""
    return -F.ctc_loss(log_probs.transpose(0, 1), labels, input_lengths, label_lengths,
                       blank=0, reduction="none", zero_infinity=False)


def _ctc_forward_reduced(log_probs: torch.Tensor, labels: torch.Tensor,
                         input_lengths: torch.Tensor, label_lengths: torch.Tensor) -> torch.Tensor:
    """Per-sample log P(labels | log_probs), [B], by the JAX package's
    ``ctc_forward_logprob`` step for step in ``log_probs``' dtype (its
    alphas start weakly typed, so ``lax.scan`` carries them in the
    emissions' dtype): ``_NEG_INF`` where no alignment exists.
    Differentiable."""
    B, T, _ = log_probs.shape
    S = 2 * labels.shape[1] + 1
    dev = log_probs.device
    labels, input_lengths, label_lengths = (t.to(dev, torch.long)
                                            for t in (labels, input_lengths, label_lengths))
    ext = torch.zeros((B, S), dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    pos = torch.arange(S, device=dev)[None]
    valid = pos <= 2 * label_lengths[:, None]
    can_skip = (pos % 2 == 1) & (ext != F.pad(ext, (2, 0))[:, :S]) & (pos >= 2)
    emit = log_probs.gather(2, ext[:, None, :].expand(B, T, S))  # [B, T, S]
    first = (pos == 1) & (label_lengths[:, None] > 0)
    alpha = torch.where(pos == 0, emit[:, 0, :1], torch.where(first, emit[:, 0, 1:2], _NEG_INF))
    alpha = torch.where(valid, alpha, _NEG_INF)
    for t in range(1, T):
        a1 = F.pad(alpha, (1, 0), value=_NEG_INF)[:, :S]
        a2 = torch.where(can_skip, F.pad(alpha, (2, 0), value=_NEG_INF)[:, :S], _NEG_INF)
        new = torch.where(valid, _logsumexp2(_logsumexp2(alpha, a1), a2) + emit[:, t], _NEG_INF)
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
    a_blank = alpha.gather(1, (2 * label_lengths)[:, None])[:, 0]
    a_last = alpha.gather(1, (2 * label_lengths - 1).clamp_min(0)[:, None])[:, 0]
    return _logsumexp2(a_blank, torch.where(label_lengths > 0, a_last, _NEG_INF))


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor, input_lengths: torch.Tensor,
             label_lengths: torch.Tensor, reduction: str = "mean",
             zero_infinity: bool = True) -> torch.Tensor:
    """Negative log-likelihood CTC loss with torch's semantics, as the JAX
    package's: "mean" divides each sample's loss by its target length
    (at least 1), then averages over the batch; ``zero_infinity`` zeroes
    the loss (and its gradient) of a sample no alignment can produce.

    ``F.ctc_loss``'s backward assumes ``log_probs`` came out of a
    ``log_softmax``: its gradient is right with respect to the logits
    upstream of that, not as a gradient of arbitrary log-probabilities."""
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"unknown reduction {reduction!r}")
    if torch.finfo(log_probs.dtype).bits >= 32:
        return F.ctc_loss(log_probs.transpose(0, 1), labels, input_lengths, label_lengths,
                          blank=0, reduction=reduction, zero_infinity=zero_infinity)
    # the JAX package's loss in the log-probabilities' dtype
    nll = -_ctc_forward_reduced(log_probs, labels, input_lengths, label_lengths)
    if zero_infinity:
        nll = torch.where(nll >= -_NEG_INF * 0.5, 0.0, nll)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    return (nll / label_lengths.to(nll.device).clamp_min(1).to(nll.dtype)).mean()


def cross_entropy_ignore_index(logits: torch.Tensor, targets: torch.Tensor,
                               ignore_index: int = 0, count=None) -> torch.Tensor:
    """``torch.nn.CrossEntropyLoss(ignore_index=...)`` of the attention head
    (reference ``crnn.py:116``): the mean NLL over the targets not ignored,
    divided by ``max(count, 1)`` so that a batch whose every target is
    ignored gives 0, not NaN.  ``logits`` [..., C], ``targets`` [...].
    ``count`` maps the local count of targets not ignored to the one to
    divide by (the whole batch's, where these rows are one shard of it)."""
    nll = -F.log_softmax(logits, dim=-1).gather(-1, targets[..., None].long())[..., 0]
    mask = (targets != ignore_index).to(nll.dtype)
    n = mask.sum() if count is None else count(mask.sum())
    return (nll * mask).sum() / n.clamp_min(1.0)


def ctc_greedy_decode(logits: torch.Tensor, blank: int = 0):
    """[B, T, C] logits -> ([B, T] int64 labels with repeats and blanks
    collapsed, left-packed and blank-padded, [B] int64 lengths).  The
    collapse is a keep mask and a stable sort, with no per-sample loop."""
    idx = logits.argmax(2)
    prev = F.pad(idx, (1, 0), value=blank)[:, :-1]
    keep = (idx != blank) & (idx != prev)
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    packed = torch.gather(torch.where(keep, idx, blank), 1, order)
    lengths = keep.sum(1)
    t = torch.arange(idx.shape[1], device=idx.device)
    return torch.where(t < lengths[:, None], packed, blank), lengths


def _hash32(mult: int, add: int, n: int, device) -> torch.Tensor:
    """``uint32(mult) * arange(n) + uint32(add)`` with uint32 wrap, in int64."""
    return (torch.arange(n, device=device) * mult + add) & _MASK32


def _seg_logsumexp(vals: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Per-row segmented logsumexp of ``vals`` [B, N] over segment ids
    ``seg`` [B, N] (each < ``n_seg``): each position gets its segment's
    total; a segment of ~-inf values totals exactly ``_NEG_INF``."""
    B = vals.shape[0]
    m = vals.new_full((B, n_seg), _NEG_INF).scatter_reduce(
        1, seg, vals, "amax", include_self=False).gather(1, seg)
    finite = m > 0.5 * _NEG_INF
    m_safe = torch.where(finite, m, 0.0)
    s = vals.new_zeros((B, n_seg)).scatter_add(1, seg, torch.exp(vals - m_safe)).gather(1, seg)
    return torch.where(finite, m_safe + torch.log(torch.where(finite, s, 1.0)), _NEG_INF)


def ctc_beam_search_decode(logits: torch.Tensor, beam_width: int = 8, blank: int = 0,
                           lm: torch.Tensor | None = None):
    """CTC prefix beam search on the device, batched, static shapes.

    [B, T, C] logits -> (labels [B, W, T] int64 blank-padded, lengths
    [B, W], scores [B, W] = log P(label sequence | input) summed over all
    alignments), beams best-first.  ``lm`` (optional, [C, C]): a
    shallow-fusion transition log-prior added once per extension,
    ``lm[last label, new label]`` (row 0 for the empty prefix); the scores
    are then fused scores.

    The same algorithm as the JAX package, step for step: per frame, the W
    stay candidates and W*C extensions are keyed by a pair of 32-bit
    rolling hashes of their prefix (uint32 arithmetic emulated in int64),
    lexsorted by (hash, hash2, -total) with two stable sorts, merged per
    equal-hash run by a segmented logsumexp (scatter max, scatter sum), and
    the W best run heads kept by a stable descending sort (``lax.top_k``'s
    lower-index-first tie order).  The loop over T makes no host sync.
    """
    if blank != 0:
        raise ValueError("blank must be class 0 (converter convention)")
    W = int(beam_width)
    logp = F.log_softmax(logits.float(), dim=-1)
    B, T, C = logp.shape
    dev = logp.device
    if lm is not None:
        lm = lm.to(dev, torch.float32)
        if tuple(lm.shape) != (C, C):
            raise ValueError(f"lm must be [C, C] = {(C, C)}, got {tuple(lm.shape)}")
    N = W + W * C
    cls = torch.arange(C, device=dev)
    w_idx = torch.arange(W, device=dev)
    cand_parent = torch.cat([w_idx, w_idx.repeat_interleave(C)]).expand(B, N)
    cand_char = torch.cat([torch.full((W,), -1, device=dev), cls.repeat(W)]).expand(B, N)
    ext_lpb = logp.new_full((B, W * C), _NEG_INF)
    dead = [_hash32(m, a, W, dev).expand(B, W) for m, a in _DEAD]
    t_pos = torch.arange(T, device=dev)

    prefixes = torch.zeros((B, W, T), dtype=torch.long, device=dev)
    lengths = torch.zeros((B, W), dtype=torch.long, device=dev)
    hashes = [torch.where(w_idx == 0, seed, _hash32(m, a, W, dev)).expand(B, W)
              for seed, (m, a) in zip((1, 2), _INIT)]
    last = torch.full((B, W), -1, dtype=torch.long, device=dev)
    lp_b = logp.new_full((B, W), _NEG_INF)
    lp_b[:, 0] = 0.0
    lp_nb = logp.new_full((B, W), _NEG_INF)

    for t in range(T):
        lp_t = logp[:, t]  # [B, C]
        total = _logsumexp2(lp_b, lp_nb)
        # stay: ends-blank from any path + blank; ends-nonblank by
        # collapsing a repeat of the prefix's own last label
        stay_b = total + lp_t[:, :1]
        last0 = last.clamp(min=0)
        stay_nb = torch.where(last >= 0, lp_nb + lp_t.gather(1, last0), _NEG_INF)
        # extend with c != blank; repeating ``last`` needs a blank between
        base = torch.where(cls == last[..., None], lp_b[..., None], total[..., None])
        ext = base + lp_t[:, None, :]
        if lm is not None:
            ext = ext + lm[last0]
        ext[..., 0] = _NEG_INF
        cand_h = [torch.cat([h, ((h[..., None] * p + cls + 1) & _MASK32).reshape(B, -1)], 1)
                  for h, p in zip(hashes, (_P, _P2))]
        cand_lpb = torch.cat([stay_b, ext_lpb], 1)
        cand_lpnb = torch.cat([stay_nb, ext.reshape(B, -1)], 1)
        cand_total = _logsumexp2(cand_lpb, cand_lpnb)

        # lexsort (hash, hash2, -total): stable by the minor key first
        key = (cand_h[0] - 2 ** 31) * 2 ** 32 + cand_h[1]  # (hash, hash2) order in one int64
        order = torch.sort(-cand_total, dim=1, stable=True).indices
        order = order.gather(1, torch.sort(key.gather(1, order), dim=1, stable=True).indices)
        key_s = key.gather(1, order)
        lpb_s, lpnb_s = cand_lpb.gather(1, order), cand_lpnb.gather(1, order)

        startseg = torch.ones_like(key_s, dtype=torch.bool)
        startseg[:, 1:] = key_s[:, 1:] != key_s[:, :-1]
        seg = torch.cumsum(startseg, 1) - 1
        lpb_seg = _seg_logsumexp(lpb_s, seg, N)
        lpnb_seg = _seg_logsumexp(lpnb_s, seg, N)
        score_rep = torch.where(startseg, _logsumexp2(lpb_seg, lpnb_seg), _NEG_INF)
        top = torch.sort(score_rep, dim=1, descending=True, stable=True).indices[:, :W]

        # fewer live runs than W: the padding picks become dead slots, not
        # duplicates of a live run (which would double-count its mass)
        sel_ok = startseg.gather(1, top)
        src = order.gather(1, top)  # candidate index of each pick
        par = cand_parent.gather(1, src)
        ch = cand_char.gather(1, src)
        hashes = [torch.where(sel_ok, h.gather(1, src), d) for h, d in zip(cand_h, dead)]
        lp_b = torch.where(sel_ok, lpb_seg.gather(1, top), _NEG_INF)
        lp_nb = torch.where(sel_ok, lpnb_seg.gather(1, top), _NEG_INF)

        extm = ch >= 0
        base_pref = prefixes.gather(1, par[..., None].expand(B, W, T))
        pos = lengths.gather(1, par)
        write = (t_pos == pos[..., None]) & extm[..., None]
        prefixes = torch.where(write, ch[..., None], base_pref)
        lengths = pos + extm.long()
        last = torch.where(extm, ch, last.gather(1, par))

    score = _logsumexp2(lp_b, lp_nb)
    order = torch.argsort(-score, dim=1, stable=True)
    return (prefixes.gather(1, order[..., None].expand(B, W, T)),
            lengths.gather(1, order), score.gather(1, order))
