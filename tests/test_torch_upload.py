"""The port's upload decode (``serving/upload.py``) vs PIL.

Where PIL is missing (the card's installation), PNG decodes in numpy.  Each
colour type (L, LA, RGB, RGBA, P) at an odd width, written by the encoder
below with one filter for every row (None, Sub, Up, Average, Paeth), must
decode bit for bit as PIL's ``Image.open(...).convert("RGB")``.  Truncated
and corrupt PNGs, and JPEG with PIL blocked, answer ``404 badInput``
through the port's app, as an undecodable upload does in the JAX package.
"""
import io
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from lightly_ocr_tpu_torch.serving import upload
from lightly_ocr_tpu_torch.serving.server import create_app

from test_torch_server import FakeModel, _make_client, _multipart

_MODES = {"L": (0, 1), "LA": (4, 2), "RGB": (2, 3), "RGBA": (6, 4), "P": (3, 1)}
_FILTERS = ["none", "sub", "up", "average", "paeth"]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def encode_png(px: np.ndarray, color_type: int, filt: int, palette: np.ndarray | None = None) -> bytes:
    """uint8 [H, W, channels] -> an 8-bit PNG whose every row uses ``filt``."""
    H, W, bpp = px.shape
    rows = px.reshape(H, W * bpp).astype(np.int16)
    up = np.vstack([np.zeros((1, W * bpp), np.int16), rows[:-1]])
    left = np.hstack([np.zeros((H, bpp), np.int16), rows[:, :-bpp]])
    upleft = np.hstack([np.zeros((H, bpp), np.int16), up[:, :-bpp]])
    pred = [0 * rows, left, up, (left + up) // 2, _paeth(left, up, upleft)][filt]
    raw = np.hstack([np.full((H, 1), filt, np.uint8), ((rows - pred) % 256).astype(np.uint8)])
    out = upload.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color_type, 0, 0, 0))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    return out + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b"")


def _image(mode: str, seed: int, H=9, W=13):
    color_type, ch = _MODES[mode]
    rng = np.random.default_rng(seed)
    if mode == "P":
        palette = rng.integers(0, 256, (200, 3), dtype=np.uint8)
        return rng.integers(0, 200, (H, W, 1), dtype=np.uint8), color_type, palette
    return rng.integers(0, 256, (H, W, ch), dtype=np.uint8), color_type, None


@pytest.mark.parametrize("filt", range(5), ids=_FILTERS)
@pytest.mark.parametrize("mode", list(_MODES))
def test_numpy_png_equals_pil(mode, filt):
    px, color_type, palette = _image(mode, seed=filt)
    data = encode_png(px, color_type, filt, palette)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = upload.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == want.shape == (9, 13, 3)
    np.testing.assert_array_equal(got, want)


def test_pil_png_files_decode_as_pil():
    """PNGs written by PIL itself (its own filter choices) decode equal."""
    rng = np.random.default_rng(1)
    for mode, shape in (("RGB", (31, 47, 3)), ("L", (17, 23)), ("RGBA", (8, 5, 4))):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(buf, format="PNG")
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        np.testing.assert_array_equal(upload.decode_png(buf.getvalue()), want)


def _bad_pngs():
    px, ct, _ = _image("RGB", 0)
    good = encode_png(px, ct, 4)
    idat = good.index(b"IDAT")
    bad_crc = bytearray(good)
    bad_crc[idat + 10] ^= 0xFF
    return {"truncated": good[: len(good) // 2], "bad_crc": bytes(bad_crc),
            "not_png": b"not a png at all", "no_iend": good[:-12],
            "bad_zlib": upload.PNG_SIGNATURE + _chunk(b"IHDR", good[16:29]) + _chunk(b"IDAT", b"xx")
            + _chunk(b"IEND", b""),
            "sixteen_bit": upload.PNG_SIGNATURE + _chunk(
                b"IHDR", struct.pack(">IIBBBBB", 13, 9, 16, 2, 0, 0, 0)) + good[33:],
            "interlaced": upload.PNG_SIGNATURE + _chunk(
                b"IHDR", struct.pack(">IIBBBBB", 13, 9, 8, 2, 0, 0, 1)) + good[33:]}


@pytest.mark.parametrize("case", list(_bad_pngs()))
def test_bad_png_raises(case):
    with pytest.raises(upload.UploadError):
        upload.decode_png(_bad_pngs()[case])


@pytest.fixture
def no_pil(monkeypatch):
    """PIL blocked, as on the card."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


def _jpeg() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.full((20, 30, 3), 128, np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


_JPEG = _jpeg()  # written while PIL is importable


@pytest.mark.parametrize("case", ["truncated", "bad_crc", "not_png", "jpeg"])
def test_undecodable_uploads_answer_404_without_pil(case, no_pil, tmp_path, caplog):
    app = create_app(FakeModel(), upload_folder=str(tmp_path))
    try:
        content = _JPEG if case == "jpeg" else _bad_pngs()[case]
        name = "receipt.jpg" if case == "jpeg" else "receipt.png"
        status, payload = _make_client(app)("POST", "/api", *_multipart(name, content))
    finally:
        app.worker.close()
    assert status.startswith("404") and payload == {"status": "badInput"}
    if case == "jpeg":
        assert "PIL" in caplog.text and "JPEG" in caplog.text


def test_png_upload_answers_200_without_pil(no_pil, tmp_path):
    px, ct, _ = _image("RGB", 3)
    app = create_app(FakeModel(), upload_folder=str(tmp_path))
    try:
        status, payload = _make_client(app)("POST", "/api", *_multipart("r.png", encode_png(px, ct, 4)))
    finally:
        app.worker.close()
    assert status == "200 OK" and payload["results"] == {"0": "total", "1": "4.20"}
    with pytest.raises(ImportError):
        from PIL import Image  # noqa: F401
