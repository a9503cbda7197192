"""Reference-name compatibility surface (port of
``lightly_ocr_tpu/compat.py``).

Users of lightly-ocr import names like ``resizeAspectRatio`` from
``ocr.tools`` or ``CRAFT`` from ``ocr.net`` (``ocr/tools/__init__.py:1-8``,
``ocr/__init__.py:1-2``).  This module gives the port's counterparts those
names, so a switch is a one-line import change:

    from lightly_ocr_tpu_torch.compat import (
        CRAFT, CRNN, prepModel, getText, serveModel,
        resizeAspectRatio, normalizeMeanVariance, getDetBoxes, ...)

Functions whose reference signatures take and give numpy arrays get thin
adapters here (they run on the CPU); everything else aliases the port's own
API.
"""
from __future__ import annotations

import numpy as np
import torch

# --- dataset / transforms (ocr/tools/dataset.py, generator.py) ---
from lightly_ocr_tpu_torch.data.generator import (  # noqa: F401
    anno2list,
    build_records as DatasetGenerator,
    check_image_valid as checkImgValid,
)
from lightly_ocr_tpu_torch.data.loader import (  # noqa: F401
    AlignCollate,
    RandomSequentialSampler,
)
from lightly_ocr_tpu_torch.data.records import RecordDataset as LMDBDataset  # noqa: F401

# --- engines / pipeline (ocr/net.py, ocr/pipeline.py) ---
from lightly_ocr_tpu_torch.engines import CRAFT, CRNN, compare_rects  # noqa: F401

# --- models (ocr/model.py, ocr/modules/*) ---
from lightly_ocr_tpu_torch.models.attention import Attention  # noqa: F401
from lightly_ocr_tpu_torch.models.crnn import CRNNet  # noqa: F401
from lightly_ocr_tpu_torch.models.lstm import BidirectionalLSTM  # noqa: F401
from lightly_ocr_tpu_torch.models.resnet import ResNet50v2  # noqa: F401
from lightly_ocr_tpu_torch.models.tps import TPS_STN  # noqa: F401
from lightly_ocr_tpu_torch.models.vgg_unet import UpConv, VGG_UNet  # noqa: F401
from lightly_ocr_tpu_torch.models.vgg_unet import VggBackbone as vgg16_bn  # noqa: F401
from lightly_ocr_tpu_torch.ops.cc import label_components
from lightly_ocr_tpu_torch.ops.detection import get_det_boxes as _get_det_boxes
from lightly_ocr_tpu_torch.ops.image import (  # noqa: F401
    denormalize_mean_variance,
    normalize_mean_variance,
    plan_aspect_resize,
    resize_bilinear,
)
from lightly_ocr_tpu_torch.pipeline import (  # noqa: F401
    calcTime,
    getText,
    prepModel,
    read_image as loadImage,
    serveModel,
)

# --- converters & metrics (ocr/tools/recog_utils.py) ---
from lightly_ocr_tpu_torch.text.converters import (  # noqa: F401
    AttnLabelConverter,
    CTCLabelConverter,
)
from lightly_ocr_tpu_torch.utils.metrics import Averager, edit_distance  # noqa: F401
from lightly_ocr_tpu_torch.weights import strip_module_prefix


def normalizeMeanVariance(in_img, mean=(0.485, 0.456, 0.406),
                          variance=(0.229, 0.224, 0.225)):
    """numpy in, numpy out (``imgproc.py:19-25``)."""
    del mean, variance  # fixed ImageNet stats, as the reference defaults
    return normalize_mean_variance(torch.as_tensor(np.asarray(in_img))).numpy()


def denormalizeMeanVariance(in_img, **_):
    return denormalize_mean_variance(torch.as_tensor(np.asarray(in_img))).numpy().astype(np.uint8)


def resizeAspectRatio(img, square_size, interpolation=None, mag_ratio=1):
    """(resized canvas, ratio, heatmap size) — ``imgproc.py:38-65``."""
    h, w = img.shape[:2]
    plan = plan_aspect_resize(h, w, square_size, mag_ratio)
    content = resize_bilinear(torch.as_tensor(np.asarray(img, np.float32)),
                              plan.target_h, plan.target_w).numpy()
    canvas = np.zeros((plan.canvas_h, plan.canvas_w, img.shape[2]), np.float32)
    canvas[: plan.target_h, : plan.target_w] = content
    return canvas, plan.ratio, (plan.heatmap_w, plan.heatmap_h)


def getDetBoxes(textmap, linkmap, text_threshold, link_threshold, low_text,
                poly=False):
    """(boxes list, polys list) — ``det_utils.py:248-256`` shape."""
    tm = torch.as_tensor(np.asarray(textmap, np.float32))[None]
    lm = torch.as_tensor(np.asarray(linkmap, np.float32))[None]
    labels = label_components((tm > low_text) | (lm > link_threshold))
    boxes, valid, cid = _get_det_boxes(
        tm, lm, labels, text_threshold=text_threshold, link_threshold=link_threshold,
        low_text=low_text, return_cid=True,
    )
    valid = valid[0].numpy()
    boxes = [b for b in boxes[0].numpy()[valid]]
    if poly:
        from lightly_ocr_tpu_torch.ops.poly import refine_polygon

        cid = cid[0].numpy()
        polys = [refine_polygon(b, cid, int(k)) for k, b in zip(np.nonzero(valid)[0], boxes)]
    else:
        polys = [None] * len(boxes)
    return boxes, polys


def adjustResultCoordinates(polys, ratio_w, ratio_h, ratio_net=2):
    """``det_utils.py:259-265`` semantics on a list of arrays."""
    return [
        None if p is None else np.asarray(p) * (ratio_w * ratio_net, ratio_h * ratio_net)
        for p in polys
    ]


def copyStateDict(state_dict):
    """``net.py:24-34``: strip DataParallel prefixes."""
    return strip_module_prefix(state_dict)
