"""Batch assembly and a prefetching loader (port of
``lightly_ocr_tpu/data/loader.py``).

``align_collate`` (reference ``ocr/tools/dataset.py:68-101``): with
``keep_ratio`` each crop is resized to the target height at its own aspect
(width capped at the target width) and right-padded by replicating its
last column; without it, a plain resize to height x width.  Values are
normalised to [-1, 1].

The resize is PIL's ``Image.resize(..., BICUBIC)`` on uint8 images,
written in numpy (:func:`resize_bicubic_uint8`) so that the loader runs on
hosts without PIL: the same filter (a = -0.5, support widened by the
downscale factor), the same per-output-pixel windows and normalised
coefficients in 22-bit fixed point, two passes (width, then height), each
rounded and clipped to uint8.  :func:`resize_bilinear_uint8` is PIL's
``BILINEAR`` by the same machinery (the detector's pseudo-label loader).

The loader is a thread-prefetched iterator over a record dataset; the
samplers draw from numpy generators as the JAX package's do, so one seed
gives the same batches in both packages.
"""
from __future__ import annotations

import functools
import math
import queue
import threading
from typing import Iterator

import numpy as np

_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit images


def _bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic filter, a = -0.5."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _triangle(x: np.ndarray) -> np.ndarray:
    """PIL's bilinear filter."""
    return np.maximum(1.0 - np.abs(x), 0.0)


# PIL's filters by name: (function, support at scale 1)
_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_triangle, 1.0)}


def _coeffs(in_size: int, out_size: int, kind: str = "bicubic") -> tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for a full-
    extent resize with the filter ``kind``: (first input index [out], int64
    fixed-point weights [out, ksize], zero past each window)."""
    fn, base_support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    k = np.arange(ksize)
    w = fn((k[None, :] + xmin[:, None] - center[:, None] + 0.5) / filterscale)
    w = np.where(k[None, :] < xmax[:, None], w, 0.0)
    ww = w.sum(1, keepdims=True)
    w = np.divide(w, ww, out=w, where=ww != 0.0)
    fixed = w * (1 << _PRECISION_BITS)
    fixed = np.where(fixed < 0, np.trunc(fixed - 0.5), np.trunc(fixed + 0.5)).astype(np.int64)
    return xmin, fixed


@functools.lru_cache(maxsize=256)
def _matrix(in_size: int, out_size: int, kind: str) -> np.ndarray:
    """The fixed-point weights of :func:`_coeffs` as a read-only float64
    [out, in] matrix (a few MB at most: word crops, detector canvases)."""
    xmin, kk = _coeffs(in_size, out_size, kind)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1])[None, :], in_size - 1)
    mat = np.zeros((out_size, in_size))
    np.add.at(mat, (np.arange(out_size)[:, None], idx), kk)  # zero weights past each window
    mat.flags.writeable = False
    return mat


def _pass(img: np.ndarray, axis: int, out_size: int, kind: str) -> np.ndarray:
    """One PIL resampling pass of uint8 ``img`` along ``axis`` (0 rows, 1
    columns), rounded and clipped to uint8.  The fixed-point sums run as a
    float64 matrix product: every term and sum is an integer below 2**53,
    so the result is PIL's integer arithmetic exactly."""
    src = np.moveaxis(img, axis, 0).astype(np.float64)
    acc = np.tensordot(_matrix(img.shape[axis], out_size, kind), src, axes=(1, 0))
    acc += 1 << (_PRECISION_BITS - 1)
    out = np.clip(np.floor(acc / (1 << _PRECISION_BITS)), 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_uint8(img: np.ndarray, width: int, height: int, kind: str) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> uint8 [height, width(, C)], as PIL's
    ``Image.resize((width, height), filter)`` for ``kind`` "bicubic" or
    "bilinear" (a pass only along an axis whose size changes, width
    first)."""
    if img.shape[1] != width:
        img = _pass(img, 1, width, kind)
    if img.shape[0] != height:
        img = _pass(img, 0, height, kind)
    return img


def resize_bicubic_uint8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's ``Image.resize((width, height), Image.BICUBIC)``."""
    return resize_uint8(img, width, height, "bicubic")


def resize_bilinear_uint8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's ``Image.resize((width, height), Image.BILINEAR)`` (antialiased
    when it shrinks: the triangle's support widens by the scale)."""
    return resize_uint8(img, width, height, "bilinear")


def resize_normalize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Bicubic resize -> [-1, 1] float32 (``dataset.py:37-47``)."""
    arr = resize_bicubic_uint8(img, width, height).astype(np.float32) / 255.0
    return (arr - 0.5) / 0.5


def align_collate(
    samples: list,
    height: int = 32,
    width: int = 100,
    keep_ratio: bool = False,
) -> tuple[np.ndarray, list[str]]:
    """[(uint8 [h, w] or [h, w, C], label)] -> (images [B, H, W, C] in
    [-1, 1], labels)."""
    images, labels = zip(*samples)
    channels = 1 if images[0].ndim == 2 else images[0].shape[2]
    out = np.zeros((len(images), height, width, channels), np.float32)
    for i, img in enumerate(images):
        arr = img if img.ndim == 3 else img[..., None]
        if keep_ratio:
            h, w = arr.shape[:2]
            resized_w = max(min(math.ceil(height * (w / max(h, 1))), width), 1)
            out[i, :, :resized_w] = resize_normalize(arr, resized_w, height)
            out[i, :, resized_w:] = out[i, :, resized_w - 1: resized_w]  # edge replicate
        else:
            out[i] = resize_normalize(arr, width, height)
    return out, list(labels)


class AlignCollate:
    """Callable-class form of :func:`align_collate` (reference API,
    ``dataset.py:68-101``)."""

    def __init__(self, height: int = 32, width: int = 100,
                 keep_ratio: bool = False):
        self.height, self.width, self.keep_ratio = height, width, keep_ratio

    def __call__(self, batch):
        batch = [b for b in batch if b is not None]
        return align_collate(batch, self.height, self.width, self.keep_ratio)


class RandomSequentialSampler:
    """Random-start contiguous batches (``dataset.py:104-125`` intent)."""

    def __init__(self, n: int, batch_size: int, seed: int = 0):
        self.n = n
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[np.ndarray]:
        for _ in range(self.n // self.batch_size):
            start = int(self.rng.integers(0, max(self.n - self.batch_size, 0) + 1))
            yield np.arange(start, start + self.batch_size)


class ShuffleSampler:
    def __init__(self, n: int, batch_size: int, seed: int = 0,
                 drop_last: bool = True):
        self.n, self.batch_size = n, batch_size
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[np.ndarray]:
        perm = self.rng.permutation(self.n)
        end = self.n - (self.n % self.batch_size) if self.drop_last else self.n
        for i in range(0, end, self.batch_size):
            yield perm[i: i + self.batch_size]


class DataLoader:
    """Thread-prefetched batches of (images, labels): ``workers`` threads
    decode and resize (numpy and zlib release the interpreter lock for most
    of it); batches come out in sampler order."""

    def __init__(
        self,
        dataset,
        batch_size: int = 64,
        height: int = 32,
        width: int = 100,
        keep_ratio: bool = False,
        shuffle: bool = True,
        random_sample: bool = True,
        seed: int = 0,
        prefetch: int = 4,
        workers: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.height, self.width = height, width
        self.keep_ratio = keep_ratio
        if shuffle or random_sample:
            self.sampler = ShuffleSampler(len(dataset), batch_size, seed)
        else:
            self.sampler = RandomSequentialSampler(len(dataset), batch_size, seed)
        self.prefetch = prefetch
        self.workers = workers

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _load_batch(self, idx: np.ndarray):
        samples = [self.dataset[int(i)] for i in idx]
        return align_collate(samples, self.height, self.width, self.keep_ratio)

    def __iter__(self):
        batches = list(self.sampler)
        stop = threading.Event()
        index_q: "queue.Queue" = queue.Queue()
        for bi, idx in enumerate(batches):
            index_q.put((bi, idx))
        results: dict[int, object] = {}
        results_lock = threading.Condition()

        def worker():
            while not stop.is_set():
                with results_lock:  # at most `prefetch` batches waiting
                    while len(results) >= self.prefetch and not stop.is_set():
                        results_lock.wait(timeout=1.0)
                try:
                    bi, idx = index_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = self._load_batch(idx)
                except Exception as e:  # handed to the consumer, raised there
                    batch = e
                with results_lock:
                    results[bi] = batch
                    results_lock.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(max(1, self.workers))]
        for t in threads:
            t.start()
        try:
            for bi in range(len(batches)):
                with results_lock:
                    while bi not in results:
                        results_lock.wait(timeout=60.0)
                    batch = results.pop(bi)
                    results_lock.notify_all()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            with results_lock:
                results_lock.notify_all()
