"""Index -> text converters (the port's copy of the JAX package's decode
side of ``lightly_ocr_tpu/text/converters.py``).

Index layouts of the reference (``ocr/tools/recog_utils.py:20-22,57-59``):

* CTC: 0 = ``[blank]``, characters at 1..N;
* Attention: 0 = ``[GO]``, 1 = ``[s]`` (EOS), characters at 2..N+1.

The encoders serve training, which is not ported yet.
"""
from __future__ import annotations

import numpy as np

from lightly_ocr_tpu_torch.config import BLANK_TOKEN, EOS_TOKEN, GO_TOKEN


class CTCLabelConverter:
    """Maps indices of the CTC head back to text."""

    def __init__(self, character: str):
        self.character = [BLANK_TOKEN] + list(character)

    @property
    def num_classes(self) -> int:
        return len(self.character)

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
    """Maps indices of the attention decoder back to text."""

    def __init__(self, character: str):
        self.character = [GO_TOKEN, EOS_TOKEN] + list(character)
        self.dict = {tok: i for i, tok in enumerate(self.character)}

    @property
    def num_classes(self) -> int:
        return len(self.character)

    @property
    def eos_index(self) -> int:
        return self.dict[EOS_TOKEN]

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
