"""Read-only adapter for reference-format LMDB datasets (port of
``lightly_ocr_tpu/data/lmdb_compat.py``).

Key schema of ``ocr/tools/dataset.py:128-193``: ``num-samples``,
``image-{i}``, ``label-{i}`` with 1-based indices.  Used only where the
optional lmdb package is installed (imported when a dataset is opened);
the native store is :mod:`.records`.
"""
from __future__ import annotations

import re

from lightly_ocr_tpu_torch.data.records import decode_image


class LMDBDataset:
    def __init__(
        self,
        root: str,
        character: str | None = None,
        batch_max_len: int | None = None,
        filtering: bool = True,
        rgb: bool = False,
    ):
        import lmdb

        self.rgb = rgb
        self.env = lmdb.open(
            root, max_readers=32, readonly=True, lock=False,
            readahead=False, meminit=False,
        )
        self._out_of_char = (
            re.compile(f"[^{re.escape(character)}]") if character else None
        )
        with self.env.begin(write=False) as txn:
            count = int(txn.get(b"num-samples"))
            keep = []
            for i in range(1, count + 1):
                if not (filtering and character is not None):
                    keep.append(i)
                    continue
                label = txn.get(f"label-{i}".encode()).decode("utf-8")
                if batch_max_len is not None and len(label) > batch_max_len:
                    continue
                if self._out_of_char.search(label.lower()):
                    continue
                keep.append(i)
        self._index = keep

    def __len__(self):
        return len(self._index)

    def raw(self, i: int):
        idx = self._index[i]
        with self.env.begin(write=False) as txn:
            label = txn.get(f"label-{idx}".encode()).decode("utf-8")
            blob = txn.get(f"image-{idx}".encode())
        return label, blob

    def __getitem__(self, i: int):
        """-> (uint8 image, cleaned label), as :class:`RecordDataset`."""
        label, blob = self.raw(i)
        img = decode_image(blob, self.rgb)
        if self._out_of_char is not None:
            label = self._out_of_char.sub("", label)
        return img, label

    def close(self):
        self.env.close()
