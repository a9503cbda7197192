"""Whole-batch OCR on one device (port of ``serving/batch.py::BatchedOCR``).

``[B, H, W, 3]`` same-bucket canvases -> the CRAFT trunk (seam form) -> the
seam-tail kernel (region and affinity maps) -> the connected-components
kernel -> batched box extraction -> rects mapped to ORIGINAL-image
coordinates -> bicubic matmul crops from the original-resolution gray
images -> one CRNN dispatch over ``B * M`` crops -> greedy decode -> the
vectorised host string decode (CTC collapse or attention EOS stops).  Only
the last step runs on the host.

The detector runs the plan the JAX package serves on its accelerator
(``_fused_kernel_plan``), read from ``Config.fused_stages`` and
``Config.quant_int8``:

* ``tail``: trunk with the seam-split decoder, then the fused tail kernel;
  without it, the plain detector (no kernel; the JAX package off its
  accelerator);
* ``stem``: conv1_1 prefix, then the full-resolution conv1_2 kernel (#4
  ``fused_stem_conv``) and the trunk resumed at pool1.  It needs the tail,
  a canvas height that ``stem_supported`` takes and ``quant_int8`` off
  (under int8 it is dropped with a warning, as in the JAX package), and it
  wins over ``cpool``, ``cpool2`` and ``s2d``, which replace the same conv;
* ``cpool2``: conv1_1 prefix, then the conv1_2 + pool + conv2_1 kernel
  (#7 ``fused_conv12_pool_conv21_q`` under ``quant_int8``, else #6), and
  the trunk resumed at conv2_2; ``cpool``: the conv1_2 + pool kernel (#5)
  and the trunk resumed at conv2_1.  Either needs the tail and a canvas
  that ``conv_pool_supported`` takes; ``cpool2`` wins over ``cpool``;
* ``s2d``: the JAX package's space-to-depth stem is a TPU layout rewrite
  of conv1_1 + conv1_2 + pool1 with both BNs folded; in bf16 the port
  computes the same roundings as ``s2d_prefix`` (conv1_1) and kernel #5
  (conv1_2 + pool), then the trunk resumed at conv2_1; on an even canvas
  that kernel #5 does not take (a width that is not a multiple of 16), the
  same folded conv1_2 + pool runs in stock ops (``conv12_pool_plain``), as
  the JAX package's ``s2d_conv12_pool`` is XLA there too.  In float32 the
  fold changes nothing but round-off, and the plain slice1 runs.

The canvas geometry picks among these per dispatch, as in the JAX package;
once a kernel is picked, a CUDA tensor launches it or the call raises.

``quant_int8`` builds both networks with w8a8 ``QuantConv`` layers.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.decode import decode_crops
from lightly_ocr_tpu_torch.models.layers import to_serving
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.ops.cc import label_components
from lightly_ocr_tpu_torch.ops.crop import crop_resize_normalize_matmul
from lightly_ocr_tpu_torch.ops.detection import get_det_boxes
from lightly_ocr_tpu_torch.ops.image import (
    LUMA,
    make_detector_input,
    pick_canvas_bucket,
    pick_gray_bucket,
    plan_aspect_resize,
)
from lightly_ocr_tpu_torch.ops.seam_tail import fused_tail_scores_cs_seam, tail_params
from lightly_ocr_tpu_torch.ops.stem import (
    conv12_pool_plain,
    conv_pool_supported,
    fused_conv12_pool,
    fused_conv12_pool_conv21,
    fused_conv12_pool_conv21_q,
    fused_stem_conv,
    s2d_prefix,
    s2d_supported,
    stem_params,
    stem_supported,
)
from lightly_ocr_tpu_torch.text.converters import build_converter

_LUMA = np.asarray(LUMA, np.float32)
log = logging.getLogger(__name__)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is not there:
    the port never falls back to the CPU on its own."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return d


class BatchedOCR:
    """The batched serving program.

    ``det_state``/``rec_state`` are state dicts of :class:`VGG_UNet` and
    :class:`CRNNet` (reference torch key names; see
    :func:`lightly_ocr_tpu_torch.weights.state_dict_from_variables`).  The
    models compute in ``dtype``; the CUDA tail kernel takes bfloat16.
    """

    def __init__(self, cfg: Config, det_state: dict, rec_state: dict,
                 boxes_per_image: int = 32, dtype: torch.dtype = torch.bfloat16,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.boxes_per_image = boxes_per_image
        stages = cfg.derived_fused_stages
        self.use_tail = "tail" in stages
        if self.use_tail and "stem" in stages and cfg.quant_int8:
            log.warning("fused stem requested but not active (quant_int8 is on) "
                        "— running without it")
        # the fused conv1_2 kernel of the plan, its prefix, the canvases it
        # takes and the trunk's resume point
        self.front, self.resume = None, None
        self.prefix = lambda canvases: self.det_net.stem_prefix(canvases)
        self.front_supported = conv_pool_supported
        self.s2d = False
        if self.use_tail and "stem" in stages and not cfg.quant_int8:
            self.front, self.resume = fused_stem_conv, "stem"
            self.front_supported = lambda h, w: stem_supported(h)
        elif self.use_tail and "cpool2" in stages:
            self.resume = "c21"
            self.front = (fused_conv12_pool_conv21_q if cfg.quant_int8
                          else fused_conv12_pool_conv21)
        elif self.use_tail and "cpool" in stages:
            self.front, self.resume = fused_conv12_pool, "pool"
        elif self.use_tail and "s2d" in stages and dtype == torch.bfloat16:
            self.front, self.resume = fused_conv12_pool, "pool"
            self.prefix = lambda canvases: s2d_prefix(canvases, self.stem)
            self.s2d = True
        det = VGG_UNet(quant=cfg.quant_int8)
        det.load_state_dict(det_state, strict=True)
        # fold the kernels' BNs from the float32 master weights, then cast
        tail = tail_params(det, dtype)
        self.tail = type(tail)(*(p.to(self.device) for p in tail))
        stem = stem_params(det)
        self.stem = type(stem)(*(p.to(self.device) for p in stem))
        fmt = torch.channels_last if self.device.type == "cuda" else torch.contiguous_format
        self.det_net = to_serving(det, self.device, dtype, fmt).eval()
        rec = CRNNet(cfg, quant=cfg.quant_int8)
        rec.load_state_dict(rec_state, strict=True)
        self.rec_net = to_serving(rec, self.device, dtype).eval()
        self.converter = build_converter(cfg.prediction, cfg.character)
        self._chartab = np.asarray(self.converter.character, dtype="<U1")

    def detector_scores(self, canvases: torch.Tensor):
        """[B, H, W, 3] normalized canvases -> (region, affinity) f32
        [B, H/2, W/2] each, by the plan of the module docstring."""
        if not self.use_tail:
            y, _ = self.det_net(canvases)
            return y[..., 0].float(), y[..., 1].float()
        front = self.front_for(*canvases.shape[1:3])
        if front is not None:
            x0 = self.prefix(canvases)
            y_lo, t = self.det_net.trunk(front(x0, self.stem), resume=self.resume)
        else:
            y_lo, t = self.det_net.trunk(canvases)
        y = fused_tail_scores_cs_seam(self.tail, y_lo, t)  # [B, H2, 2, W2]
        return y[:, :, 0], y[:, :, 1]

    def front_for(self, h: int, w: int):
        """The conv1_2 front that the plan runs on an ``h x w`` canvas: its
        kernel where the kernel takes the canvas; on the ``s2d`` plan, any
        other even canvas takes the stock-ops fold; else None (the plain
        slice1)."""
        if self.front is None:
            return None
        if self.front_supported(h, w):
            return self.front
        return conv12_pool_plain if self.s2d and s2d_supported(h, w) else None

    def boxes(self, tmaps, lmaps, inv_ratio, extents):
        """Score maps -> (rects [B, M, 4] as (r0, c0, r1, c1) in ORIGINAL-
        image coordinates, valid [B, M]): connected components, batched box
        extraction, then the heatmap -> image mapping (x2 net ratio and
        1/plan.ratio per image, truncated per corner, clipped to each
        image's true extent; gray may be zero-padded up to a shared
        bucket).  Invalid rows get the dummy rect (0, 0, 1, 1)."""
        cfg = self.cfg
        fg = (tmaps > cfg.low_text) | (lmaps > cfg.link_threshold)
        labels = label_components(fg.contiguous())
        boxes, valid = get_det_boxes(
            tmaps, lmaps, labels,
            text_threshold=cfg.text_threshold,
            link_threshold=cfg.link_threshold,
            low_text=cfg.low_text,
            max_boxes=self.boxes_per_image,
        )
        scaled = torch.trunc(boxes * (2.0 * inv_ratio[:, None, None, None]))
        c0 = scaled[..., 0].amin(2)
        r0 = scaled[..., 1].amin(2)
        c1 = scaled[..., 0].amax(2)
        r1 = scaled[..., 1].amax(2)
        H0 = extents[:, 0:1]
        W0 = extents[:, 1:2]
        r0 = torch.minimum(torch.clamp(r0, min=0.0), H0)
        r1 = torch.minimum(torch.clamp(r1, min=0.0), H0)
        c0 = torch.minimum(torch.clamp(c0, min=0.0), W0)
        c1 = torch.minimum(torch.clamp(c1, min=0.0), W0)
        valid = valid & (r1 > r0) & (c1 > c0)
        rects = torch.stack([r0, c0, r1, c1], -1)
        dummy = torch.tensor([0.0, 0.0, 1.0, 1.0], device=rects.device)
        return torch.where(valid[..., None], rects, dummy), valid

    def recognize(self, gray, rects):
        """gray [B, H0, W0] and rects [B, M, 4] -> (pred_idx [B, M, T],
        confidence [B, M] f32): bicubic crops, one CRNN dispatch over the
        B * M crops, greedy decode of its head."""
        B, M = rects.shape[:2]
        idx, conf = decode_crops(self.rec_net, self.crops(gray, rects), self.cfg)
        return idx.reshape(B, M, -1), conf.float().reshape(B, M)

    def crops(self, gray, rects):
        """[B, H0, W0] gray, [B, M, 4] rects -> [B * M, height, width, 1]
        normalized recognizer inputs."""
        cfg = self.cfg
        crops = crop_resize_normalize_matmul(gray, rects, cfg.height, cfg.width)
        return crops.reshape(-1, cfg.height, cfg.width, 1)

    def postprocess(self, tmaps, lmaps, gray, inv_ratio, extents) -> dict:
        rects, valid = self.boxes(tmaps, lmaps, inv_ratio, extents)
        idx, conf = self.recognize(gray, rects)
        return {"rects": rects, "valid": valid, "pred_idx": idx, "confidence": conf}

    @torch.inference_mode()
    def __call__(self, canvases, gray, inv_ratio, extents) -> dict:
        """canvases [B, H, W, 3] normalized; gray [B, H0, W0] ORIGINAL-
        resolution luma in [0, 255]; inv_ratio [B] = 1 / plan.ratio;
        extents [B, 2] true (h0, w0).  Rects come back in original-image
        coordinates."""
        tmaps, lmaps = self.detector_scores(canvases)
        return self.postprocess(tmaps, lmaps, gray, inv_ratio, extents)

    def group(self, images: list) -> dict:
        """{(canvas bucket, gray bucket): [image indices]} of one request
        batch; each group is one dispatch."""
        cfg, groups = self.cfg, {}
        for i, img in enumerate(images):
            h, w = img.shape[:2]
            cb = pick_canvas_bucket(h, w, cfg.canvas_size, cfg.magnify_ratio,
                                    granularity=cfg.bucket_granularity)
            gb = pick_gray_bucket(h, w, cfg.gray_granularity)
            groups.setdefault((cb, gb), []).append(i)
        return groups

    def prepare(self, images: list, cb, gb):
        """One group's RGB uint8 images -> the arguments of :meth:`__call__`
        on the device, padded to a power-of-two batch (pad rows are blank
        canvases with a 1x1 extent, so they yield no valid box)."""
        cfg, dev = self.cfg, self.device
        B = 1 << (len(images) - 1).bit_length()
        canv = torch.zeros((B, *cb, 3), dtype=torch.float32, device=dev)
        grays = np.zeros((B, *gb), np.float32)
        inv_ratios = np.ones((B,), np.float32)
        extents = np.ones((B, 2), np.float32)
        for j, image in enumerate(images):
            img = np.asarray(image, np.float32)
            h, w = img.shape[:2]
            plan = plan_aspect_resize(h, w, cfg.canvas_size, cfg.magnify_ratio,
                                      canvas_bucket=cb)
            canv[j] = make_detector_input(torch.from_numpy(img).to(dev), plan)
            grays[j, :h, :w] = img @ _LUMA
            inv_ratios[j] = 1.0 / plan.ratio
            extents[j] = (float(h), float(w))
        return (canv, torch.from_numpy(grays).to(dev),
                torch.from_numpy(inv_ratios).to(dev), torch.from_numpy(extents).to(dev))

    def run_images(self, images: list) -> list[list[dict]]:
        """RGB uint8 images of mixed sizes -> per image [{text, confidence,
        rect}], one dispatch per (canvas bucket, gray bucket) group."""
        results: list = [None] * len(images)
        for (cb, gb), idxs in self.group(images).items():
            out = self(*self.prepare([images[i] for i in idxs], cb, gb))
            for i, items in zip(idxs, self.decode(out)):
                results[i] = items
        return results

    def decode(self, out: dict) -> list[list[dict]]:
        """Device outputs -> per image [{text, confidence, rect}]; the
        character lookup, the CTC collapse and the EOS stops are vectorised
        over [B, M, T]."""
        valid = out["valid"].cpu().numpy()
        idx = out["pred_idx"].cpu().numpy()
        conf = out["confidence"].cpu().numpy()
        rects = out["rects"].cpu().numpy()
        B, M, T = idx.shape
        ctc = self.cfg.prediction == "CTC"
        chars = np.ascontiguousarray(self._chartab[idx])
        if ctc:
            # greedy collapse: keep frames that are not blank and differ
            # from the frame before
            prev = np.concatenate([np.full((B, M, 1), -1, idx.dtype), idx[..., :-1]], -1)
            keep = (idx != 0) & (idx != prev)
        else:
            full = chars.view(f"<U{T}")[..., 0]  # [B, M] full strings
            eos = idx == self.converter.eos_index
            stop = np.where(eos.any(-1), eos.argmax(-1), T)
            # '[GO]' (index 0) is a multi-char token the '<U1' table
            # truncates; rows that emit it before EOS take the converter's
            # own decode
            go_before_stop = ((idx == 0) & (np.arange(T) < stop[..., None])).any(-1)
        results = []
        for b in range(B):
            items = []
            for m in np.nonzero(valid[b])[0]:
                if ctc:
                    text = "".join(chars[b, m][keep[b, m]])
                elif go_before_stop[b, m]:
                    text = self.converter.decode_trimmed(idx[b, m][None])[0]
                else:
                    text = full[b, m][: stop[b, m]]
                items.append({
                    "text": text,
                    "confidence": float(conf[b, m]),
                    "rect": rects[b, m].tolist(),
                })
            results.append(items)
        return results
