"""Attention label converter (the port's copy of the JAX package's).

Index layout of ``lightly_ocr_tpu/text/converters.py::AttnLabelConverter``
(reference ``ocr/tools/recog_utils.py:57-59``): 0 = ``[GO]``, 1 = ``[s]``
(EOS), characters at 2..N+1.  The CTC converter is not ported yet.
"""
from __future__ import annotations

import numpy as np

from lightly_ocr_tpu_torch.config import EOS_TOKEN, GO_TOKEN


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
