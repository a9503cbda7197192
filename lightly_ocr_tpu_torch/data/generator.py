"""Dataset generation: MJSynth -> records, LMDB -> records, synthetic words
(port of ``lightly_ocr_tpu/data/generator.py``).

Counterpart of ``ocr/tools/generator.py``: ``anno2list`` parses MJSynth
``annotation_*.txt`` where the label is the second ``_``-separated field
of the filename (``generator.py:27-40``); images failing a decode check
are skipped and logged to ``error_image.txt`` (``generator.py:66-71``).

``synthesize_words`` has no reference counterpart: it renders random
charset strings to PNG bytes so training/eval/benchmarks run without the
(unfetchable) MJSynth tarball.  PIL is imported inside the functions that
decode-check or render images, so the module imports without it.
"""
from __future__ import annotations

import io
import os
from typing import Iterable, Sequence

import numpy as np

from lightly_ocr_tpu_torch.config import DEFAULT_CHARSET
from lightly_ocr_tpu_torch.data.records import RecordWriter


def anno2list(data_dir: str, annotation: str = "annotation_train.txt"):
    """-> list of (image_path, label) from an MJSynth annotation file."""
    out = []
    with open(os.path.join(data_dir, annotation)) as f:
        for line in f:
            rel = line.strip().split(" ")[0]
            if not rel:
                continue
            name = os.path.basename(rel)
            parts = name.split("_")
            if len(parts) < 2:
                continue
            out.append((os.path.join(data_dir, rel), parts[1]))
    return out


def check_image_valid(blob: bytes) -> bool:
    from PIL import Image

    try:
        img = Image.open(io.BytesIO(blob))
        img.verify()
        return True
    except Exception:
        return False


def build_records(
    samples: Iterable[tuple[str, str]],
    out_path: str,
    log_dir: str | None = None,
) -> int:
    """Write (path, label) samples into a record file; returns count."""
    errors = []
    n = 0
    with RecordWriter(out_path) as w:
        for path, label in samples:
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError:
                errors.append(path)
                continue
            if not check_image_valid(blob):
                errors.append(path)
                continue
            w.add(label, blob)
            n += 1
    if log_dir and errors:
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "error_image.txt"), "a") as f:
            f.write("\n".join(errors) + "\n")
    return n


def convert_mjsynth(data_dir: str, out_path: str,
                    annotation: str = "annotation_train.txt",
                    log_dir: str | None = None) -> int:
    return build_records(anno2list(data_dir, annotation), out_path, log_dir)


def convert_lmdb(lmdb_root: str, out_path: str) -> int:
    """Reference LMDB -> records (requires the optional lmdb package)."""
    from lightly_ocr_tpu_torch.data.lmdb_compat import LMDBDataset

    ds = LMDBDataset(lmdb_root, filtering=False)
    with RecordWriter(out_path) as w:
        for i in range(len(ds)):
            label, blob = ds.raw(i)
            w.add(label, blob)
    ds.close()
    return len(ds)


# Receipt-domain vocabulary (charset-only: lowercase alnum) for
# structured synthetic words — a character-bigram LM prior
# (scripts/build_lm_prior.py) is uniform over uniformly-random strings,
# so demonstrating the LM (and any realistic recognizer eval) needs
# text with actual statistics.
RECEIPT_VOCAB = (
    "total subtotal cash change tax vat item items qty quantity price "
    "amount receipt thank you store shop date time card visa debit "
    "credit discount sale net gross due paid payment balance tender "
    "refund void cashier register invoice order table guest server "
    "coffee tea milk bread butter cheese sugar rice pasta water juice "
    "apple banana orange lemon chicken beef pork fish egg salt pepper "
    "oil flour soap paper towel batteries small medium large each per "
    "kg lb pack box bottle can jar piece dozen no number ref code "
    "terminal approved signature customer copy merchant account member "
    "points earned redeemed savings coupon promo offer open close"
).split()


def render_word(
    text: str,
    rng: np.random.Generator,
    height: int | None = None,
    noise: float = 0.0,
) -> bytes:
    """Render one word to grayscale PNG bytes (synthetic MJSynth stand-in).

    The glyphs scale with the image height (PIL's default bitmap font is
    ~11 px regardless of canvas; characters must fill the crop or the
    32x100 recognizer input degenerates to specks).  ``height`` pins the
    crop height (used by :func:`synthesize_receipt` to place words on a
    line grid); default: random 24-48.  ``noise`` adds gaussian pixel
    noise (std in gray levels) plus a light blur above std 8 — the
    degraded-eval knob for decoder comparisons."""
    from PIL import Image, ImageDraw, ImageFont

    h = int(rng.integers(24, 48)) if height is None else int(height)
    w = max(int(len(text) * h * 0.62) + 6, 16)
    bg = int(rng.integers(180, 255))
    fg = int(rng.integers(0, 80))
    img = Image.new("L", (w, h), bg)
    d = ImageDraw.Draw(img)
    try:
        font = ImageFont.load_default(size=int(h * 0.62))
    except TypeError:  # older Pillow without sized default font
        font = ImageFont.load_default()
    d.text((3, int(h * 0.12)), text, fill=fg, font=font)
    if noise > 0:
        from PIL import ImageFilter

        if noise >= 8:
            img = img.filter(ImageFilter.GaussianBlur(radius=0.8))
        arr = np.asarray(img, np.float32)
        arr = arr + rng.standard_normal(arr.shape) * noise
        img = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def sample_word(
    rng: np.random.Generator,
    charset: str = DEFAULT_CHARSET,
    min_len: int = 1,
    max_len: int = 10,
    vocab: Sequence[str] | None = None,
    vocab_frac: float = 0.0,
) -> str:
    """One synthetic label: with probability ``vocab_frac`` a vocabulary
    word (default :data:`RECEIPT_VOCAB`), else a uniform charset string."""
    if vocab_frac > 0 and rng.random() < vocab_frac:
        words = RECEIPT_VOCAB if vocab is None else vocab
        return words[int(rng.integers(0, len(words)))]
    k = int(rng.integers(min_len, max_len + 1))
    return "".join(rng.choice(list(charset), size=k))


def synthesize_words(
    out_path: str,
    n: int = 256,
    charset: str = DEFAULT_CHARSET,
    min_len: int = 1,
    max_len: int = 10,
    seed: int = 4420,
    vocab_frac: float = 0.0,
    noise: float = 0.0,
) -> list[str]:
    """Write n synthetic word records; returns the labels.

    ``vocab_frac`` mixes in receipt-vocabulary words (structured text
    for LM/decoder evals); ``noise`` degrades the renders (see
    :func:`render_word`)."""
    rng = np.random.default_rng(seed)
    labels = []
    with RecordWriter(out_path) as w:
        for _ in range(n):
            text = sample_word(
                rng, charset, min_len, max_len, vocab_frac=vocab_frac
            )
            w.add(text, render_word(text, rng, noise=noise))
            labels.append(text)
    return labels


def synthesize_receipt(
    rng: np.random.Generator,
    height: int = 320,
    width: int = 256,
    charset: str = DEFAULT_CHARSET,
    min_len: int = 2,
    max_len: int = 8,
    margin: int = 10,
    vocab_frac: float = 0.5,
) -> tuple[np.ndarray, list[dict]]:
    """Compose one synthetic receipt from :func:`render_word` crops.

    Returns ``(rgb_uint8 [H, W, 3] equal-channel, words)`` where
    ``words = [{"rect": [r0, c0, r1, c1], "text": str}, ...]`` — the
    LOR1 detection annotation shape consumed by
    ``lightly_ocr_tpu/train/pseudo_labels.py::write_detection_records``.
    Words flow line by line with >=24 px horizontal separation so the
    affinity supervision (within-word only) matches the visual layout;
    dark glyphs min-compose onto light paper noise like a printed
    receipt.  No reference counterpart (the reference ships pretrained
    weights instead of detector training data,
    ``README.md:87-91,110`` of the reference)."""
    from PIL import Image

    paper = np.clip(
        235 + rng.standard_normal((height, width)) * 4.0, 0, 255
    )
    words: list[dict] = []
    r = margin
    while True:
        line_h = int(rng.integers(20, 34))
        if r + line_h + margin >= height:
            break
        c = margin + int(rng.integers(0, 24))
        while True:
            text = sample_word(
                rng, charset, min_len, max_len, vocab_frac=vocab_frac
            )
            crop = np.asarray(
                Image.open(
                    io.BytesIO(render_word(text, rng, height=line_h))
                ).convert("L"),
                np.float64,
            )
            wh, ww = crop.shape
            if c + ww + margin > width:
                break
            paper[r : r + wh, c : c + ww] = np.minimum(
                paper[r : r + wh, c : c + ww], crop
            )
            words.append(
                {"rect": [r, c, r + wh, c + ww], "text": text}
            )
            c += ww + int(rng.integers(24, 56))
        r += line_h + int(rng.integers(10, 22))
    g = paper.astype(np.uint8)
    return np.stack([g, g, g], axis=-1), words


def synthesize_receipt_crops(
    out_path: str,
    n: int = 4096,
    height: int = 320,
    width: int = 256,
    charset: str = DEFAULT_CHARSET,
    seed: int = 4420,
    vocab_frac: float = 0.5,
) -> list[str]:
    """Write ``n`` word records CROPPED from composed receipts — the
    serving distribution, not the clean-render one.

    :func:`synthesize_words` renders tight, clean word images; the
    pipeline's recognizer instead sees detector crops: paper noise
    around the glyphs, box-boundary error in BOTH directions (the
    watershed cores run 2-4 px TIGHTER than the glyph extents, clipping
    ascenders/descenders; dilation can also add loose margins), and
    line-grid scale.  A recognizer trained only on clean renders drops
    from ~94% held-out to ~17% through the real detect->crop->read
    chain; margin-only (non-negative) jitter recovers just ~24%
    (measured with the JAX package's demo recognizer) — so margins are jittered from -3 px
    (shaving into the glyphs, the tight-box case) up to ~1/3 word
    height vertically / ~1/2 horizontally."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    labels: list[str] = []
    with RecordWriter(out_path) as w:
        while len(labels) < n:
            image, words = synthesize_receipt(
                rng, height, width, charset=charset, vocab_frac=vocab_frac
            )
            gray = image[:, :, 0]
            for wd in words:
                if len(labels) >= n:
                    break
                r0, c0, r1, c1 = wd["rect"]
                wh = r1 - r0
                # independent per-edge jitter, negative = shave into
                # the glyphs like a tight watershed box
                e = [int(rng.integers(-3, max(4, wh // 3)))
                     for _ in range(2)]
                f = [int(rng.integers(-3, max(4, wh // 2)))
                     for _ in range(2)]
                rr0 = max(0, min(r0 - e[0], r1 - 8))
                rr1 = min(height, max(r1 + e[1], rr0 + 8))
                cc0 = max(0, min(c0 - f[0], c1 - 8))
                cc1 = min(width, max(c1 + f[1], cc0 + 8))
                crop = gray[rr0:rr1, cc0:cc1]
                buf = io.BytesIO()
                Image.fromarray(crop).save(buf, format="PNG")
                w.add(wd["text"], buf.getvalue())
                labels.append(wd["text"])
    return labels


def main(argv: Sequence[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="dataset generator")
    sub = p.add_subparsers(dest="cmd", required=True)
    mj = sub.add_parser("mjsynth", help="MJSynth folder -> records")
    mj.add_argument("data_dir")
    mj.add_argument("out")
    mj.add_argument("--annotation", default="annotation_train.txt")
    lm = sub.add_parser("lmdb", help="reference LMDB -> records")
    lm.add_argument("lmdb_root")
    lm.add_argument("out")
    sy = sub.add_parser("synth", help="synthetic words -> records")
    sy.add_argument("out")
    sy.add_argument("-n", type=int, default=1024)
    sy.add_argument("--seed", type=int, default=4420)
    args = p.parse_args(argv)
    if args.cmd == "mjsynth":
        n = convert_mjsynth(args.data_dir, args.out, args.annotation)
    elif args.cmd == "lmdb":
        n = convert_lmdb(args.lmdb_root, args.out)
    else:
        n = len(synthesize_words(args.out, args.n, seed=args.seed))
    print(f"wrote {n} records to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
