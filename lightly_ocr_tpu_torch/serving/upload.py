"""Upload bytes -> RGB uint8 image, for the HTTP front end.

Where PIL imports, uploads decode exactly as in the JAX package's server
(``Image.open(...).convert("RGB")``).  Where it does not (the card's
installation has no PIL), PNG decodes here with ``zlib`` and numpy:
8-bit, non-interlaced, colour types 0 (L), 2 (RGB), 3 (palette), 4 (LA)
and 6 (RGBA), alpha dropped as ``convert("RGB")`` drops it, all five row
filters.  Every other image (JPEG, 16-bit, 1/2/4-bit, interlaced, corrupt
or truncated) raises :class:`UploadError`, which the front end answers with
``404 badInput``, as the JAX package answers an upload PIL cannot read.

None, Sub and Up unfilter as whole-row numpy operations; Average and Paeth
depend on the unfiltered byte to the left and run a byte loop per row.
"""
from __future__ import annotations

import io
import logging
import struct
import zlib

import numpy as np

log = logging.getLogger("lightly_ocr_tpu_torch.server")

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


class UploadError(ValueError):
    """The upload is not an image this host can decode."""


def decode_upload(content: bytes) -> np.ndarray:
    """Image file bytes -> RGB uint8 [H, W, 3]; raises on anything it cannot
    decode (:class:`UploadError` without PIL, PIL's own errors with it)."""
    try:
        from PIL import Image
    except ImportError:
        if not content.startswith(PNG_SIGNATURE):
            log.error("no decoder for this upload: PIL is not installed and "
                      "only PNG decodes without it (JPEG needs PIL)")
            raise UploadError("not a PNG, and no PIL to decode it") from None
        return decode_png(content)
    return np.asarray(Image.open(io.BytesIO(content)).convert("RGB"))


def _chunks(data: bytes):
    """(type, payload) of each PNG chunk, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        end = pos + 12 + length
        if end > len(data):
            raise UploadError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(ctype + body) != crc:
            raise UploadError(f"PNG chunk {ctype!r}: bad CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end
    raise UploadError("PNG ends before IEND")


def unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """PNG-filtered scanlines [H, 1 + stride] uint8 -> pixels [H, stride]."""
    H, stride = raw.shape[0], raw.shape[1] - 1
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        ftype, line = raw[y, 0], raw[y, 1:]
        if ftype == 0:
            row = line.copy()
        elif ftype == 1:  # Sub: a running sum per channel, mod 256
            row = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            row = line + prev
        elif ftype == 3:  # Average: a byte loop
            cur, up = bytearray(line.tobytes()), prev.tolist()
            for i in range(bpp):
                cur[i] = (cur[i] + (up[i] >> 1)) & 0xFF
            for i in range(bpp, stride):
                cur[i] = (cur[i] + ((cur[i - bpp] + up[i]) >> 1)) & 0xFF
            row = np.frombuffer(bytes(cur), np.uint8)
        elif ftype == 4:  # Paeth: a byte loop
            cur, up = bytearray(line.tobytes()), prev.tolist()
            for i in range(bpp):  # left and upper-left are 0: the predictor is up
                cur[i] = (cur[i] + up[i]) & 0xFF
            for i in range(bpp, stride):
                a, b, c = cur[i - bpp], up[i], up[i - bpp]
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            row = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise UploadError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = row
        prev = row
    return out


def decode_png(data: bytes) -> np.ndarray:
    """8-bit non-interlaced PNG bytes -> RGB uint8 [H, W, 3], as PIL's
    ``convert("RGB")`` gives it; :class:`UploadError` for anything else."""
    if not data.startswith(PNG_SIGNATURE):
        raise UploadError("not a PNG")
    header, palette, idat = None, None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            if len(body) != 13:
                raise UploadError("bad IHDR")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = body
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise UploadError("PNG without IHDR or IDAT")
    width, height, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0 or comp != 0 or filt != 0:
        raise UploadError(f"unsupported PNG without PIL: bit depth {depth}, colour type "
                          f"{ctype}, interlace {interlace} (8-bit non-interlaced only)")
    if width == 0 or height == 0:
        raise UploadError("empty PNG")
    ch = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise UploadError(f"corrupt PNG data: {e}") from None
    if len(raw) != height * (1 + width * ch):
        raise UploadError("PNG data does not match its size")
    px = unfilter(np.frombuffer(raw, np.uint8).reshape(height, 1 + width * ch), ch)
    px = px.reshape(height, width, ch)
    if ctype == 3:
        if palette is None or len(palette) % 3:
            raise UploadError("palette PNG without a valid PLTE")
        lut = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(palette, np.uint8).reshape(-1, 3)[:256]
        lut[:len(entries)] = entries
        return lut[px[..., 0]]
    if ch <= 2:  # L, LA
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])
