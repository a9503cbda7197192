"""Greedy (best-path) CTC decode on the device.

Port of ``lightly_ocr_tpu/ops/ctc.py::ctc_greedy_decode``.  The prefix beam
search and the CTC losses of that module are not ported yet
(``models/decode.py`` refuses ``ctc_decode="beam"``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
