"""Text <-> index converters (the port's copy of
``lightly_ocr_tpu/text/converters.py``): encoders for training, decoders
for inference.

Index layouts of the reference (``ocr/tools/recog_utils.py:20-22,57-59``):

* CTC: 0 = ``[blank]``, characters at 1..N;
* Attention: 0 = ``[GO]``, 1 = ``[s]`` (EOS), characters at 2..N+1.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from lightly_ocr_tpu_torch.config import BLANK_TOKEN, EOS_TOKEN, GO_TOKEN


def _lookup(table: dict, text: str, who: str) -> list[int]:
    try:
        return [table[ch] for ch in text]
    except KeyError as e:
        raise ValueError(
            f"{who}: character {e.args[0]!r} in {text!r} is not in the "
            "charset; filter labels first (see data pipeline `filtering`)"
        ) from None


class CTCLabelConverter:
    """Maps text <-> indices of the CTC head."""

    def __init__(self, character: str):
        self.dict = {ch: i + 1 for i, ch in enumerate(character)}
        self.character = [BLANK_TOKEN] + list(character)

    @property
    def num_classes(self) -> int:
        return len(self.character)

    def encode(self, texts: Sequence[str], batch_max_len: int = 25):
        """(flat int32 indices of all samples concatenated, int32 lengths),
        the reference's layout (``recog_utils.py:24-30``)."""
        lengths = np.asarray([len(s) for s in texts], dtype=np.int32)
        flat = np.asarray(
            [i for s in texts for i in _lookup(self.dict, s, "CTC encode")],
            dtype=np.int32,
        )
        return flat, lengths

    def encode_padded(self, texts: Sequence[str], batch_max_len: int = 25):
        """([B, batch_max_len] int32 labels padded with 0 = blank, [B] int32
        lengths), the layout of :func:`lightly_ocr_tpu_torch.ops.ctc.ctc_loss`."""
        batch = np.zeros((len(texts), batch_max_len), dtype=np.int32)
        lengths = np.zeros((len(texts),), dtype=np.int32)
        for i, s in enumerate(texts):
            idx = _lookup(self.dict, s, "CTC encode")[:batch_max_len]
            batch[i, : len(idx)] = idx
            lengths[i] = len(idx)
        return batch, lengths

    def decode(self, indices, lengths) -> list[str]:
        """Greedy collapse per sample: repeats merged, then blanks dropped.
        ``indices`` is the flat concatenation of the samples, ``lengths``
        their lengths (``net.py:165-167``)."""
        indices = np.asarray(indices).reshape(-1)
        texts, start = [], 0
        for n in np.asarray(lengths).reshape(-1):
            chars, prev = [], -1
            for i in indices[start:start + int(n)]:
                i = int(i)
                if i != 0 and i != prev:
                    chars.append(self.character[i])
                prev = i
            texts.append("".join(chars))
            start += int(n)
        return texts

    def decode_padded(self, batch_indices) -> list[str]:
        """Decode a [B, T] array of per-frame argmax indices."""
        batch_indices = np.asarray(batch_indices)
        return self.decode(batch_indices.reshape(-1),
                           np.full((batch_indices.shape[0],), batch_indices.shape[1]))

    def decode_labels(self, batch_labels, lengths=None) -> list[str]:
        """Decode FINAL label sequences (blank-free, repeats resolved, as a
        beam search emits them; collapsing again would eat genuine double
        letters).  [B, T] blank-padded -> strings; without ``lengths`` a row
        stops at its first blank."""
        out = []
        for b, row in enumerate(np.asarray(batch_labels)):
            if lengths is not None:
                row = row[: int(np.asarray(lengths).reshape(-1)[b])]
            chars = []
            for i in row:
                i = int(i)
                if i == 0:
                    if lengths is None:
                        break
                    continue
                chars.append(self.character[i])
            out.append("".join(chars))
        return out


class AttnLabelConverter:
    """Maps text <-> indices of the attention decoder."""

    def __init__(self, character: str):
        self.character = [GO_TOKEN, EOS_TOKEN] + list(character)
        self.dict = {tok: i for i, tok in enumerate(self.character)}

    @property
    def num_classes(self) -> int:
        return len(self.character)

    @property
    def eos_index(self) -> int:
        return self.dict[EOS_TOKEN]

    def encode(self, texts: Sequence[str], batch_max_len: int = 25):
        """([B, batch_max_len + 2] int32, [B] int32 lengths): position 0 is
        [GO], then the text, then [s], padded with [GO] (0); a length is
        len(text) + 1 (``recog_utils.py:83-92``, every sample encoded)."""
        lengths = np.asarray([len(s) + 1 for s in texts], dtype=np.int32)
        batch = np.zeros((len(texts), batch_max_len + 2), dtype=np.int32)
        for i, s in enumerate(texts):
            idx = _lookup(self.dict, s, "Attn encode") + [self.eos_index]
            batch[i, 1 : 1 + len(idx)] = idx
        return batch, lengths

    def decode_trimmed(self, batch_indices) -> list[str]:
        """Decode and truncate at the first EOS; ``[GO]`` (a control token
        an untrained decoder can emit) is skipped, not rendered."""
        out = []
        for row in np.asarray(batch_indices):
            chars = []
            for i in row:
                if int(i) == self.eos_index:
                    break
                if int(i) == 0:  # [GO]
                    continue
                chars.append(self.character[int(i)])
            out.append("".join(chars))
        return out


def build_converter(prediction: str, character: str):
    if prediction == "CTC":
        return CTCLabelConverter(character)
    if prediction == "Attention":
        return AttnLabelConverter(character)
    raise ValueError(f"unknown prediction head {prediction!r}")
