"""Packed record dataset, the LMDB replacement (port of
``lightly_ocr_tpu/data/records.py``; the same ``LOR1`` files).

Layout (little-endian):
    magic  b"LOR1"
    u64    num_records
    u64    index_offset
    records: [u32 label_len][label utf8][u32 image_len][image bytes] ...
    index  : num_records x u64 record offsets

As the reference's ``LMDBDataset`` (``ocr/tools/dataset.py:139-156,
190-191``): labels longer than ``batch_max_len`` or with characters out of
the charset (after lowercasing) are filtered out when the file is opened,
and the out-of-charset characters of a kept label are stripped.

Images come back as uint8 numpy arrays ([H, W] gray, or [H, W, 3] with
``rgb``).  Where PIL imports, they decode as the JAX package decodes them
(``Image.open(...).convert("L" | "RGB")``).  Without PIL (the card's
installation), PNG decodes in numpy (:func:`serving.upload.decode_png`,
equal to PIL's RGB) and turns gray by PIL's integer luma rule; any other
format raises.
"""
from __future__ import annotations

import io
import mmap
import os
import re
import struct

import numpy as np

from lightly_ocr_tpu_torch.serving.upload import PNG_SIGNATURE, decode_png

MAGIC = b"LOR1"
_HDR = struct.Struct("<4sQQ")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


def luma_uint8(rgb: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> [H, W], PIL's ``convert("L")``:
    ``(R * 19595 + G * 38470 + B * 7471 + 0x8000) >> 16``."""
    x = rgb.astype(np.uint32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def decode_image(blob: bytes, rgb: bool = False) -> np.ndarray:
    """Image file bytes -> uint8 [H, W] (or [H, W, 3] with ``rgb``)."""
    try:
        from PIL import Image
    except ImportError:
        if not blob.startswith(PNG_SIGNATURE):
            raise RuntimeError(
                "a record holds an image that is not a PNG, and PIL is not "
                "installed to decode it (only PNG decodes without PIL)") from None
        img = decode_png(blob)
        return img if rgb else luma_uint8(img)
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB" if rgb else "L"))


class RecordWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._f = open(path, "wb")
        self._f.write(_HDR.pack(MAGIC, 0, 0))
        self._offsets: list[int] = []

    def add(self, label: str, image_bytes: bytes) -> None:
        self._offsets.append(self._f.tell())
        lb = label.encode("utf-8")
        self._f.write(_U32.pack(len(lb)))
        self._f.write(lb)
        self._f.write(_U32.pack(len(image_bytes)))
        self._f.write(image_bytes)

    def close(self) -> None:
        index_offset = self._f.tell()
        for off in self._offsets:
            self._f.write(_U64.pack(off))
        self._f.seek(0)
        self._f.write(_HDR.pack(MAGIC, len(self._offsets), index_offset))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordDataset:
    """Random-access reader with the reference's label filtering."""

    def __init__(
        self,
        path: str,
        character: str | None = None,
        batch_max_len: int | None = None,
        filtering: bool = True,
        rgb: bool = False,
    ):
        self.path = path
        self.rgb = rgb
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        magic, count, index_offset = _HDR.unpack_from(self._mm, 0)
        if magic != MAGIC:
            raise ValueError(f"{path}: not a LOR1 record file")
        self._offsets = np.frombuffer(
            self._mm, dtype="<u8", count=count, offset=index_offset
        ).copy()  # copy: a live view would pin the mmap open
        self.character = character
        self._out_of_char = (
            re.compile(f"[^{re.escape(character)}]") if character else None
        )
        if filtering and character is not None:
            keep = []
            for i in range(count):
                label = self._label_at(int(self._offsets[i]))
                if batch_max_len is not None and len(label) > batch_max_len:
                    continue
                if self._out_of_char.search(label.lower()):
                    continue
                keep.append(i)
            self._index = np.asarray(keep, dtype=np.int64)
        else:
            self._index = np.arange(count, dtype=np.int64)

    def _label_at(self, off: int) -> str:
        (n,) = _U32.unpack_from(self._mm, off)
        return self._mm[off + 4: off + 4 + n].decode("utf-8")

    def __len__(self) -> int:
        return len(self._index)

    def raw(self, i: int) -> tuple[str, bytes]:
        off = int(self._offsets[self._index[i]])
        (n,) = _U32.unpack_from(self._mm, off)
        label = self._mm[off + 4: off + 4 + n].decode("utf-8")
        off2 = off + 4 + n
        (m,) = _U32.unpack_from(self._mm, off2)
        return label, self._mm[off2 + 4: off2 + 4 + m]

    def __getitem__(self, i: int) -> tuple[np.ndarray, str]:
        """-> (uint8 image, gray [H, W] or RGB [H, W, 3]; cleaned label)."""
        label, blob = self.raw(i)
        img = decode_image(blob, self.rgb)
        if self._out_of_char is not None:
            label = self._out_of_char.sub("", label)
        return img, label

    def close(self) -> None:
        self._mm.close()
        self._file.close()


class ConcatDataset:
    """Concatenation of record datasets (the reference's multi-corpus
    ``select_data``, minus the per-corpus batch ratios: the shuffler samples
    uniformly over the concatenation)."""

    def __init__(self, parts):
        if not parts:
            raise ValueError("ConcatDataset needs at least one part")
        self.parts = list(parts)
        self._cum = np.cumsum([len(p) for p in self.parts])

    def __len__(self) -> int:
        return int(self._cum[-1])

    def __getitem__(self, i: int):
        i = int(i)
        if i < 0:
            i += len(self)
        part = int(np.searchsorted(self._cum, i, side="right"))
        prev = 0 if part == 0 else int(self._cum[part - 1])
        return self.parts[part][i - prev]

    def close(self) -> None:
        for p in self.parts:
            p.close()


def open_dataset(root: str, **kwargs):
    """Open a dataset root: a ``.lor`` record file, a directory holding
    ``data.lor``, a comma-separated list of roots (concatenated), or, where
    the lmdb package is installed, a reference LMDB directory."""
    if "," in root:
        return ConcatDataset(
            [open_dataset(r.strip(), **kwargs) for r in root.split(",")]
        )
    if os.path.isfile(root):
        return RecordDataset(root, **kwargs)
    lor = os.path.join(root, "data.lor")
    if os.path.isfile(lor):
        return RecordDataset(lor, **kwargs)
    if os.path.isfile(os.path.join(root, "data.mdb")):
        try:
            import lmdb  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                f"{root} looks like an LMDB dataset but the lmdb package is "
                "not installed; convert it with "
                "lightly_ocr_tpu_torch.data.generator.convert_lmdb"
            ) from e
        from lightly_ocr_tpu_torch.data.lmdb_compat import LMDBDataset

        return LMDBDataset(root, **kwargs)
    raise FileNotFoundError(f"no dataset found under {root}")
