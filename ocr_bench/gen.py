"""Traffic generators: receipts and word images, each a function of a seed
and the numbers of a traffic file.

The receipt and word generators are copies of the ones the repository's
chip smoke test uses, so the benchmark's inputs stay fixed whatever later
changes the program's own scripts.
"""
from __future__ import annotations

import numpy as np


def receipts(rng: np.random.Generator, n: int, h: int, w: int) -> list:
    """Synthetic receipts, uint8 RGB [h, w, 3]: dark text-like blocks in
    rows on a light noisy ground."""
    out = []
    for _ in range(n):
        g = np.full((h, w), 225.0) + rng.normal(0, 4, (h, w))
        y = 30
        while y < h - 40:
            x = int(rng.integers(20, 80))
            while x < w - 60:
                bw = min(int(rng.integers(20, 90)), w - 20 - x)
                bh = int(rng.integers(10, 18))
                g[y:y + bh, x:x + bw] = rng.uniform(10, 70, (bh, bw))
                x += bw + int(rng.integers(10, 30))
            y += int(rng.integers(24, 40))
        g = np.clip(g, 0, 255)
        out.append(np.repeat(g[..., None], 3, -1).astype(np.uint8))
    return out


def glyph_font(charset: str, seed: int) -> dict:
    """A seeded bitmap font: one random 20x9 binary glyph a character, a
    5x3 grid of 4x3-pixel blocks (coarse enough to survive the ResNet's
    pooling)."""
    rng = np.random.default_rng(seed)
    return {c: np.kron(rng.random((5, 3)) < 0.5, np.ones((4, 3), bool)) for c in charset}


def word_image(text: str, font: dict, rng: np.random.Generator) -> np.ndarray:
    """``text`` drawn with ``font`` as uint8 gray [32, 11 * len + 6]: dark
    glyphs on a light noisy ground."""
    img = np.full((32, 11 * len(text) + 6), float(rng.integers(190, 240)))
    ink = float(rng.integers(10, 70))
    for i, c in enumerate(text):
        img[6:26, 3 + 11 * i: 12 + 11 * i][font[c]] = ink
    img += rng.normal(0.0, 6.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def words(rng: np.random.Generator, n: int, charset: str, min_len: int, max_len: int) -> list:
    """``n`` distinct words of ``min_len`` to ``max_len`` characters."""
    seen, out = set(), []
    chars = np.array(list(charset))
    while len(out) < n:
        t = "".join(rng.choice(chars, size=int(rng.integers(min_len, max_len + 1))))
        if t not in seen:
            seen.add(t)
            out.append(t)
    return out

