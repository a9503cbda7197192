"""Per-image inference engines: the CRAFT detector and the CRNN recognizer.

Port of ``lightly_ocr_tpu/engines.py`` (reference ``ocr/net.py:37-193``):
model + weights + pre/post glue behind ``load()`` / ``process()``.

* ``CRAFT.detect_rects(image)``: canvas on the device -> the plain
  ``VGG_UNet`` (cuDNN convs; no fused tail, as in the JAX engines) ->
  connected components (kernel #2, ``csrc/cc.cu``, on the card) -> box
  extraction -> rects in image coordinates, clipped, in reading order; one
  host sync at the end.
* ``CRNN.process_batch(gray, rects)``: every rect of an image in one
  dispatch, padded to a box bucket with degenerate ``[0, 0, 1, 1]`` rects so
  the card sees a bounded set of crop-batch shapes.

Weights: ``CRAFT.pth``/``CRNN.pth`` in ``cfg.pretrained`` (or
``model_path``), reference torch format, loaded with ``strict=True``
(:func:`lightly_ocr_tpu_torch.weights.load_state_dict_file`); without a
file, random weights from ``seed`` and a warning naming the missing path.
The engines compute in float32 unless asked otherwise, and run on the card
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import functools
import logging
import os
from typing import Sequence

import numpy as np
import torch

from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.decode import decode_crops
from lightly_ocr_tpu_torch.models.layers import init_module, to_serving
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.ops.cc import label_components
from lightly_ocr_tpu_torch.ops.crop import crop_resize_normalize_matmul
from lightly_ocr_tpu_torch.ops.detection import boxes_to_rects, get_det_boxes
from lightly_ocr_tpu_torch.ops.image import (
    make_detector_input,
    pick_canvas_bucket,
    plan_aspect_resize,
    resize_normalize,
    rgb_to_gray,
)
from lightly_ocr_tpu_torch.ops.poly import refine_polygon
from lightly_ocr_tpu_torch.serving.batch import resolve_device
from lightly_ocr_tpu_torch.text.converters import build_converter
from lightly_ocr_tpu_torch.weights import load_state_dict_file

log = logging.getLogger(__name__)

_BOX_BUCKETS = (8, 16, 32, 64, 128, 256)


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def compare_rects(a, b) -> int:
    """Reading-order comparator for rects (row0, col0, row1, col1)
    (``det_utils.py:8-26``): fully-above sorts first, then leftmost start,
    topmost, smaller."""
    if a[2] <= b[0]:
        return -1
    if b[2] <= a[0]:
        return 1
    for i in (1, 0, 3, 2):
        if a[i] != b[i]:
            return -1 if a[i] < b[i] else 1
    return 0


def sort_rects(rects: np.ndarray) -> np.ndarray:
    idx = sorted(range(len(rects)), key=functools.cmp_to_key(
        lambda i, j: compare_rects(rects[i], rects[j])))
    return rects[np.asarray(idx, dtype=np.int64)] if len(rects) else rects


def _float32(x, device) -> torch.Tensor:
    """An array or tensor as a float32 tensor on ``device`` (arrays are
    copied, so read-only ones, e.g. from PIL, are fine)."""
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def _weights(net, state_dict, path: str, seed: int) -> dict:
    """``state_dict`` if given, else the checkpoint at ``path``, else the
    seeded random weights of ``net`` (with a warning naming ``path``)."""
    if state_dict is not None:
        return state_dict
    if os.path.isfile(path):
        return load_state_dict_file(path)
    log.warning("no checkpoint at %s: %s gets random weights from seed %d",
                path, type(net).__name__, seed)
    return init_module(net, torch.Generator().manual_seed(seed)).state_dict()


class _Engine:
    """Shared loading: the float32 weights go into ``net`` with
    ``strict=True``, which then moves to the device and dtype; the loaded
    weights stay in ``state_dict`` (the JAX engines' ``variables``)."""

    checkpoint = ""

    def __init__(self, cfg, state_dict, model_path, seed, dtype, device):
        self.cfg = cfg or Config()
        self.device = resolve_device(device)
        self.dtype = dtype
        self.state_dict = state_dict
        self.model_path = model_path
        self.net = None
        self.load(seed)

    def _build(self):
        raise NotImplementedError

    def load(self, seed: int = 0) -> None:
        if self.net is not None:
            return
        net = self._build()
        path = self.model_path or os.path.join(self.cfg.pretrained, self.checkpoint)
        self.state_dict = _weights(net, self.state_dict, path, seed)
        net.load_state_dict(self.state_dict, strict=True)
        fmt = torch.channels_last if self.device.type == "cuda" else torch.contiguous_format
        self.net = to_serving(net, self.device, self.dtype, fmt).eval()


class CRAFT(_Engine):
    """Detector engine (counterpart of ``net.py:37-113``)."""

    checkpoint = "CRAFT.pth"

    def __init__(self, cfg: Config | None = None, state_dict: dict | None = None,
                 model_path: str | None = None, seed: int = 0,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__(cfg, state_dict, model_path, seed, dtype, device)

    def _build(self):
        return VGG_UNet(quant=self.cfg.quant_int8)

    def _plan(self, image: np.ndarray):
        h, w = image.shape[:2]
        cfg = self.cfg
        bucket = pick_canvas_bucket(h, w, cfg.canvas_size, cfg.magnify_ratio,
                                    granularity=cfg.bucket_granularity)
        return plan_aspect_resize(h, w, cfg.canvas_size, cfg.magnify_ratio,
                                  canvas_bucket=bucket)

    def _scores(self, image: np.ndarray):
        """-> (float32 maps [h, w, 2] on the device, resize plan)."""
        plan = self._plan(image)
        img = _float32(image, self.device)
        y, _ = self.net(make_detector_input(img, plan)[None])
        return y[0].float(), plan

    def _boxes(self, y: torch.Tensor, return_cid: bool = False):
        cfg = self.cfg
        tm, lm = y[None, ..., 0], y[None, ..., 1]
        fg = (tm > cfg.low_text) | (lm > cfg.link_threshold)
        return get_det_boxes(
            tm, lm, label_components(fg.contiguous()),
            text_threshold=cfg.text_threshold, link_threshold=cfg.link_threshold,
            low_text=cfg.low_text, max_boxes=cfg.max_boxes, return_cid=return_cid,
        )

    @torch.inference_mode()
    def score_maps(self, image: np.ndarray) -> tuple[np.ndarray, float]:
        """-> (region/affinity maps [h, w, 2], content ratio)."""
        y, plan = self._scores(image)
        return y.cpu().numpy(), plan.ratio

    @torch.inference_mode()
    def detect_rects(self, image: np.ndarray) -> np.ndarray:
        """[N, 4] int32 rects (row0, col0, row1, col1) in image coordinates,
        reading order, clipped to the image."""
        y, plan = self._scores(image)
        boxes, valid = self._boxes(y)
        inv = 1.0 / plan.ratio
        rects = boxes_to_rects(boxes[0], valid[0], inv, inv).cpu().numpy()
        rects = rects[valid[0].cpu().numpy()]
        h, w = image.shape[:2]
        rects[:, 0::2] = np.clip(rects[:, 0::2], 0, h)
        rects[:, 1::2] = np.clip(rects[:, 1::2], 0, w)
        rects = rects[(rects[:, 2] > rects[:, 0]) & (rects[:, 3] > rects[:, 1])]
        return sort_rects(rects)

    def process(self, image: np.ndarray) -> list[np.ndarray]:
        """Reference-compatible API: ROI crops in reading order
        (``net.py:100-113``)."""
        return [image[r[0]:r[2], r[1]:r[3]] for r in self.detect_rects(image)]

    @torch.inference_mode()
    def detect_polygons(self, image: np.ndarray):
        """Boxes and, with ``cfg.enable_poly``, refined curved-text polygons
        (the reference computes its polygons and then overwrites them with
        the boxes, ``net.py:87``; this is the intended behaviour).  Returns
        (boxes [N, 4, 2] image coords, polys: a [14, 2] array or None each)."""
        y, plan = self._scores(image)
        boxes, valid, cid = self._boxes(y, return_cid=True)
        valid = valid[0].cpu().numpy()
        boxes_hm = boxes[0].cpu().numpy()[valid]
        polys = [None] * len(boxes_hm)
        if self.cfg.enable_poly:
            cid = cid[0].cpu().numpy()
            polys = [refine_polygon(b, cid, int(k))
                     for k, b in zip(np.nonzero(valid)[0], boxes_hm)]
        scale = 2.0 / plan.ratio  # heatmap -> original image
        return boxes_hm * scale, [None if p is None else p * scale for p in polys]


class CRNN(_Engine):
    """Recognizer engine (counterpart of ``net.py:116-193``)."""

    checkpoint = "CRNN.pth"

    def __init__(self, cfg: Config | None = None, state_dict: dict | None = None,
                 model_path: str | None = None, seed: int = 0,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__(cfg, state_dict, model_path, seed, dtype, device)
        self.converter = build_converter(self.cfg.prediction, self.cfg.character)

    def _build(self):
        return CRNNet(self.cfg, quant=self.cfg.quant_int8)

    def decode(self, idx: np.ndarray) -> list[str]:
        if self.cfg.prediction == "CTC":
            return self.converter.decode_padded(idx)
        return self.converter.decode_trimmed(idx)

    def _read(self, crops: torch.Tensor, n: int) -> tuple[list[str], np.ndarray]:
        idx, conf = decode_crops(self.net, crops, self.cfg)
        return self.decode(idx[:n].cpu().numpy()), conf[:n].float().cpu().numpy()

    @torch.inference_mode()
    def process_batch(self, image_gray, rects: np.ndarray) -> tuple[list[str], np.ndarray]:
        """Every rect of ``image_gray`` [H, W] in one (bucketed) dispatch ->
        (texts, confidences)."""
        n = len(rects)
        if n == 0:
            return [], np.zeros((0,), np.float32)
        padded = np.zeros((_bucket_for(n, _BOX_BUCKETS), 4), np.float32)
        padded[:n] = rects
        padded[n:] = [0, 0, 1, 1]  # degenerate but valid rects
        gray = _float32(image_gray, self.device)
        crops = crop_resize_normalize_matmul(
            gray[None], torch.from_numpy(padded).to(self.device)[None],
            self.cfg.height, self.cfg.width)[0]
        return self._read(crops, n)

    @torch.inference_mode()
    def recognize_crops(self, crops) -> tuple[list[str], np.ndarray]:
        """crops [K, height, width, 1] normalized -> (texts, confidences)."""
        crops = _float32(crops, self.device)
        return self._read(crops, len(crops))

    @torch.inference_mode()
    def process(self, result: dict, image: np.ndarray):
        """Reference-compatible per-crop API (``net.py:174-193``): gray
        uint8 crop -> ``result[confidence] = text``."""
        img = _float32(image, self.device)
        crop = resize_normalize(img[None], self.cfg.height, self.cfg.width)
        texts, conf = self._read(crop, 1)
        result[float(conf[0])] = texts[0]
        return texts[0], result


def gray_from_rgb(image: np.ndarray) -> np.ndarray:
    """Host helper: HxWx3 RGB -> HxW luma float32."""
    return rgb_to_gray(torch.from_numpy(np.asarray(image, np.float32))).numpy()
