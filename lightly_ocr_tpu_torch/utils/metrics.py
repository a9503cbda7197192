"""Training metrics: running loss average, Levenshtein distance, accuracy
(the port's copy of ``lightly_ocr_tpu/utils/metrics.py``).

Parity with ``ocr/tools/recog_utils.py:122-166`` (Averager, edit_distance);
edit distance also backs the normalized-edit-distance metric that the
reference left as a FIXME (``crnn.py:159``).
"""
from __future__ import annotations

import numpy as np


class Averager:
    """Running mean over scalar losses or arrays (recog_utils.py:122-142)."""

    def __init__(self):
        self.reset()

    def add(self, v) -> None:
        arr = np.asarray(v)
        self.n_count += arr.size
        self.sum += float(arr.sum())

    def reset(self) -> None:
        self.n_count = 0
        self.sum = 0.0

    def val(self) -> float:
        if self.n_count == 0:
            return 0.0
        return self.sum / float(self.n_count)


def edit_distance(s1: str, s2: str, subs: int = 1) -> int:
    """Levenshtein distance, vectorized row DP (recog_utils.py:157-166)."""
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    if not s2:
        return len(s1)
    a = np.frombuffer(s1.encode("utf-32-le"), dtype=np.uint32)
    b = np.frombuffer(s2.encode("utf-32-le"), dtype=np.uint32)
    prev = np.arange(len(b) + 1, dtype=np.int64)
    for i, c in enumerate(a):
        cur = np.empty_like(prev)
        cur[0] = i + 1
        sub_cost = prev[:-1] + np.where(b != c, subs, 0)
        np.minimum(sub_cost, prev[1:] + 1, out=cur[1:])
        # insertion needs a sequential scan: cur[j] = min(cur[j], cur[j-1]+1)
        np.minimum.accumulate(cur - np.arange(len(cur)), out=cur)
        cur += np.arange(len(cur))
        prev = cur
    return int(prev[-1])


def exact_match_accuracy(preds: list[str], labels: list[str]) -> float:
    """Exact-match accuracy in percent (crnn.py:229-235 semantics)."""
    if not labels:
        return 0.0
    correct = sum(p == g for p, g in zip(preds, labels))
    return correct / float(len(labels)) * 100.0


def normalized_edit_distance(preds: list[str], labels: list[str]) -> float:
    """Mean 1 - ED/max(len), the ICDAR2019 metric."""
    if not labels:
        return 0.0
    total = 0.0
    for p, g in zip(preds, labels):
        denom = max(len(p), len(g))
        total += 1.0 - (edit_distance(p, g) / denom if denom else 0.0)
    return total / len(labels)
