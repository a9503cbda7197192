"""CRAFT pseudo-labels: word boxes -> character supervision (port of
``lightly_ocr_tpu/train/pseudo_labels.py``).

Real detection data ships word boxes and transcripts; the CRAFT recipe
trains on character gaussians.  As the JAX package, each word is split by
its ink projection profile (valleys between characters, snapped near the
uniform grid, the uniform split where the profile is flat):

    word rect + transcript
      -> :func:`char_boxes_from_word`   (profile-valley character rects)
      -> :func:`render_craft_targets`   (half-res region/affinity maps)
      -> :func:`batches_from_records`   (batches for ``train_craft``)

Detection samples live in the ``LOR1`` record container: the label is JSON
``{"words": [{"rect": [r0, c0, r1, c1], "text": "..."}]}`` and the image a
PNG.  Nothing here needs PIL: records are encoded by
:func:`~lightly_ocr_tpu_torch.data.records.encode_png`, decoded by
:func:`~lightly_ocr_tpu_torch.data.records.decode_image`, and resized by
PIL's antialiased bilinear written in numpy
(:func:`~lightly_ocr_tpu_torch.data.loader.resize_bilinear_uint8`, equal to
PIL's bit for bit), so the batches equal the JAX package's.
"""
from __future__ import annotations

import json
from typing import Iterator, Sequence

import numpy as np
import torch

from lightly_ocr_tpu_torch.data.loader import resize_bilinear_uint8
from lightly_ocr_tpu_torch.data.records import RecordDataset, RecordWriter, decode_image, encode_png
from lightly_ocr_tpu_torch.train.craft import _paste_gaussian, batch_to

# numpy mirror of ops.image.normalize_mean_variance (host data path)
_MEAN = np.asarray((0.485, 0.456, 0.406), np.float32) * 255.0
_VAR = np.asarray((0.229, 0.224, 0.225), np.float32) * 255.0


def _ink_profile(crop: np.ndarray) -> np.ndarray:
    """Column-wise darkness of a gray word crop, smoothed: high where
    strokes are, low in the gaps.  The paper level is the 90th-percentile
    brightness (in a dense word most pixels are ink, so not the median)."""
    paper = np.percentile(crop, 90)
    ink = np.maximum(0.0, paper - crop.astype(np.float32))
    p = ink.sum(axis=0)
    if p.size >= 3:  # 3-tap box smooth kills single-column speckle
        p = np.convolve(p, np.ones(3, np.float32) / 3.0, mode="same")
    return p


def char_boxes_from_word(
    gray: np.ndarray, rect: Sequence[float], text: str
) -> np.ndarray:
    """Split one word rect into per-character rects.

    ``gray`` is the full image [H, W]; ``rect`` = (r0, c0, r1, c1) in image
    coordinates; ``text`` fixes the character count.  Splits start on the
    uniform grid and snap to the deepest ink valley within +/- width/(3n).
    Returns [n, 4] rects (r0, c0, r1, c1), n = max(len(text), 1)."""
    h, w = gray.shape
    r0 = int(np.clip(np.floor(rect[0]), 0, h - 1))
    c0 = int(np.clip(np.floor(rect[1]), 0, w - 1))
    r1 = int(np.clip(np.ceil(rect[2]), r0 + 1, h))
    c1 = int(np.clip(np.ceil(rect[3]), c0 + 1, w))
    n = max(len(text), 1)
    width = c1 - c0
    if n == 1 or width < 2 * n:
        edges = np.linspace(c0, c1, n + 1)
    else:
        profile = _ink_profile(gray[r0:r1, c0:c1])
        # a tiny distance penalty toward the uniform anchor: a flat profile
        # gives the exact uniform split, not argmin's first-index bias
        span = float(profile.max() - profile.min())
        edges = [float(c0)]
        win = max(1, width // (3 * n))
        for i in range(1, n):
            u = c0 + width * i / n  # uniform anchor
            lo = int(max(u - win - c0, 1))
            hi = int(min(u + win - c0 + 1, width - 1))
            if hi <= lo:
                edges.append(u)
                continue
            pos = np.arange(lo, hi, dtype=np.float32)
            penalty = (span + 1.0) * 0.02 * np.abs(pos - (u - c0)) / win
            valley = lo + int(np.argmin(profile[lo:hi] + penalty))
            edges.append(float(c0 + valley))
        edges.append(float(c1))
        edges = np.maximum.accumulate(np.asarray(edges))  # keep monotone
    boxes = np.empty((n, 4), np.float32)
    for i in range(n):
        boxes[i] = (r0, edges[i], r1, edges[i + 1])
    return boxes


def render_craft_targets(
    h2: int, w2: int, words_char_boxes: Sequence[np.ndarray]
) -> tuple[np.ndarray, np.ndarray]:
    """Character rects (image coordinates) -> half-res region/affinity maps:
    a gaussian per character, and one per adjacent in-word pair spanning
    the rows (10% expanded) and the inner quarters of both characters (the
    geometry ``synthesize_batch`` trains on)."""
    region = np.zeros((h2, w2), np.float32)
    affinity = np.zeros((h2, w2), np.float32)
    for char_boxes in words_char_boxes:
        prev = None
        for r0, c0, r1, c1 in np.asarray(char_boxes, np.float32):
            _paste_gaussian(region, r0 / 2, c0 / 2, r1 / 2, c1 / 2)
            center = ((r0 + r1) / 2, (c0 + c1) / 2)
            if prev is not None:
                (pc, pw), hh = prev, r1 - r0
                _paste_gaussian(
                    affinity,
                    (r0 - 0.1 * hh) / 2,
                    (pc[1] - 0.25 * pw) / 2,
                    (r1 + 0.1 * hh) / 2,
                    (center[1] + 0.25 * (c1 - c0)) / 2,
                )
            prev = (center, c1 - c0)
    return region, affinity


# ---------------------------------------------------------------------------
# Detection records (LOR1 container, JSON word annotations)
# ---------------------------------------------------------------------------


def write_detection_records(path: str, samples: Iterator[tuple]) -> int:
    """``samples`` yields (rgb_uint8 [H,W,3] | PNG bytes, words) where
    ``words`` = [{"rect": [r0,c0,r1,c1], "text": str}, ...]; arrays are
    encoded as PNG without PIL.  Returns the count written."""
    n = 0
    with RecordWriter(path) as wr:
        for image, words in samples:
            if isinstance(image, np.ndarray):
                image = encode_png(image.astype(np.uint8))
            wr.add(json.dumps({"words": list(words)}), image)
            n += 1
    return n


def _decode_sample(label: str, blob: bytes) -> tuple[np.ndarray, list]:
    return decode_image(blob, rgb=True), json.loads(label)["words"]


def sample_to_training_item(
    image: np.ndarray,
    words: list,
    height: int,
    width: int,
) -> dict[str, np.ndarray]:
    """One annotated uint8 RGB image -> normalized canvas + pseudo-label
    targets.  The image is resized per axis (PIL's bilinear; the boxes
    scale with it); characters are split on the resized gray, so the
    profile valleys line up with what the net sees."""
    h0, w0 = image.shape[:2]
    sy, sx = height / h0, width / w0
    resized = resize_bilinear_uint8(image.astype(np.uint8), width, height).astype(np.float32)
    gray = resized @ np.asarray([0.299, 0.587, 0.114], np.float32)
    char_boxes = []
    for wd in words:
        r0, c0, r1, c1 = wd["rect"]
        rect = (r0 * sy, c0 * sx, r1 * sy, c1 * sx)
        char_boxes.append(char_boxes_from_word(gray, rect, wd["text"]))
    region, affinity = render_craft_targets(height // 2, width // 2, char_boxes)
    return {"image": (resized - _MEAN) / _VAR, "region": region, "affinity": affinity}


def batches_from_records(
    path: str,
    batch: int,
    height: int,
    width: int,
    rng: np.random.Generator,
    rows: slice | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Endless batches drawn with ``rng`` (with replacement), shaped as
    ``synthesize_batch``'s, so ``train_craft(records=...)`` is a drop-in
    swap.  ``rows`` (a slice of the ``batch`` drawn) decodes only those
    rows: one process's share of a data-parallel run's global batch."""
    ds = RecordDataset(path, filtering=False)
    try:
        if len(ds) == 0:
            raise ValueError(f"{path}: empty detection record file")
        while True:
            idx = rng.integers(0, len(ds), size=batch)[slice(None) if rows is None else rows]
            images = np.empty((len(idx), height, width, 3), np.float32)
            region = np.empty((len(idx), height // 2, width // 2), np.float32)
            affinity = np.empty_like(region)
            for j, i in enumerate(idx):
                item = sample_to_training_item(*_decode_sample(*ds.raw(int(i))), height, width)
                images[j] = item["image"]
                region[j] = item["region"]
                affinity[j] = item["affinity"]
            yield {"images": images, "region": region, "affinity": affinity}
    finally:
        ds.close()


@torch.no_grad()
def eval_region_iou(model: torch.nn.Module, batch: dict[str, np.ndarray],
                    thresh: float = 0.35) -> float:
    """IoU of the thresholded predicted region map against the target, the
    model in ``eval()`` (running statistics; its mode is put back after):
    the progress metric of records-backed training."""
    was_training = model.training
    model.eval()
    try:
        dev = next(model.parameters()).device
        maps, _ = model(batch_to({"images": batch["images"]}, dev)["images"])
    finally:
        model.train(was_training)
    pred = maps[..., 0].float().cpu().numpy() > thresh
    tgt = batch["region"] > thresh
    inter = float(np.sum(pred & tgt))
    union = float(np.sum(pred | tgt))
    return inter / union if union else 0.0
