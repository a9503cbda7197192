"""Whole-batch OCR on one device, or on each replica of a mesh (port of
``serving/batch.py::BatchedOCR``).

``[B, H, W, 3]`` same-bucket canvases -> the CRAFT trunk (seam form) -> the
seam-tail kernel (region and affinity maps) -> the connected-components
kernel -> batched box extraction -> rects mapped to ORIGINAL-image
coordinates -> bicubic matmul crops from the original-resolution gray
images -> one CRNN dispatch over ``B * M`` crops -> the decode of
``models/decode.py`` (greedy or beam, with the optional LM prior of
``cfg.ctc_lm_path``) -> the vectorised host string decode (CTC collapse,
CTC beam labels, or attention EOS stops).  Only
the last step runs on the host.

The detector runs the plan the JAX package serves on its accelerator
(``_fused_kernel_plan``), read from ``Config.fused_stages`` (which
``LIGHTLY_OCR_ENABLE_FUSED`` overrides: ``none`` turns every stage off,
else a comma list; a stage asked for there that cannot run is warned of),
``Config.fused_impl`` (``LIGHTLY_OCR_FUSED_IMPL``) and
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

``fused_impl="rowpack"`` replaces the hand kernels of the ``stem`` plan
(#4) and of the tail (#1) by the row-packed stock convs of
:mod:`..ops.rowpack`, the tail on the trunk's concat (``trunk(seam=False)``);
``cpool``, ``cpool2`` and ``s2d``, which ride the seam kernel, are off under
it.  ``stage_fns`` is the dispatch's two stage functions (detector scores |
the rest), for per-stage timing; ``Config.monolith`` and
``Config.cpool_pool`` choose among XLA programs in the JAX package and have
no effect here (one eager program computes every form).

The canvas geometry picks among these per dispatch, as in the JAX package;
once a kernel is picked, a CUDA tensor launches it or the call raises.

``mesh`` (:func:`lightly_ocr_tpu_torch.parallel.make_mesh`) keeps one
replica of both networks on each data-axis device and splits every batch
into contiguous chunks, one a replica, each run to the end of the program
on its own device, CUDA stream and thread (one pool of threads, until
:meth:`BatchedOCR.close`); the outputs come back on the first device in
batch order (the JAX package's ``shard_map`` over the data axis, the
reference's ``nn.DataParallel``).  A model axis adds no work: the JAX
program's weights are replicated over it and its devices compute the same
rows again, of which one copy is kept.

``quant_int8`` builds both networks with w8a8 ``QuantConv`` layers.
"""
from __future__ import annotations

import itertools
import logging
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.decode import decode_crops, load_lm_prior
from lightly_ocr_tpu_torch.models.layers import to_serving
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.ops.cc import label_components
from lightly_ocr_tpu_torch.ops.crop import crop_resize_normalize_matmul
from lightly_ocr_tpu_torch.ops.detection import get_det_boxes
from lightly_ocr_tpu_torch.ops.image import (
    normalize_mean_variance,
    pick_canvas_bucket,
    pick_gray_bucket,
    plan_aspect_resize,
    resize_bilinear,
    rgb_to_gray,
)
from lightly_ocr_tpu_torch.ops.rowpack import stem_conv_rowpacked, tail_scores_rowpacked
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
from lightly_ocr_tpu_torch.parallel.mesh import shard_batch
from lightly_ocr_tpu_torch.text.converters import build_converter
from lightly_ocr_tpu_torch.utils.profiling import SYNC, annotate, count

log = logging.getLogger(__name__)

_OFF = ("", "none", "off", "0")


def enabled_stages(cfg: Config) -> tuple[frozenset, bool]:
    """(the fused stages to run, whether they were asked for explicitly):
    ``LIGHTLY_OCR_ENABLE_FUSED`` overrides ``Config.fused_stages`` (``none``
    / ``off`` / ``0`` / empty turn every stage off, else a comma list), as
    in the JAX package's ``_fused_kernel_plan``."""
    env = os.environ.get("LIGHTLY_OCR_ENABLE_FUSED")
    if env is None:
        return cfg.derived_fused_stages, False
    if env.strip().lower() in _OFF:
        return frozenset(), True
    return frozenset(t.strip() for t in env.split(",")), True


def fused_impl(cfg: Config) -> str:
    """``pallas`` (the hand kernels) or ``rowpack`` (:mod:`..ops.rowpack`):
    ``LIGHTLY_OCR_FUSED_IMPL`` overrides ``Config.fused_impl``."""
    return os.environ.get("LIGHTLY_OCR_FUSED_IMPL", "").strip() or cfg.fused_impl


def warn_unhonoured(stages: frozenset, use_tail: bool, front, s2d: bool) -> None:
    """Warn, as the JAX package does, of each stage asked for explicitly
    (``LIGHTLY_OCR_ENABLE_FUSED``) that the plan cannot run."""
    if "stem" in stages and not use_tail:
        log.warning("fused stem requested but not active (requires the fused tail "
                    "enabled, a supported canvas height, and quant_int8 off) — "
                    "running without it")
    cpool_fronts = (fused_conv12_pool, fused_conv12_pool_conv21, fused_conv12_pool_conv21_q)
    if {"cpool", "cpool2"} & stages and front not in cpool_fronts:
        log.warning("fused conv1_2+pool requested but not active (requires the fused "
                    "tail with the seam kernel — not rowpack —, an even-split canvas, "
                    "and no 'stem' in the enable set) — running without it")
    if "s2d" in stages and not s2d:
        log.warning("s2d stem requested but not active (requires the seam tail "
                    "kernel — not rowpack —, bfloat16, an even canvas, and no "
                    "stem/cpool stage in the enable set) — running without it")


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
                 device="cuda", mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            device = mesh.data_devices[0]
        self.device = resolve_device(device)
        self.dtype = dtype
        self.boxes_per_image = boxes_per_image
        stages, explicit = enabled_stages(cfg)
        self.impl = fused_impl(cfg)
        stem_conv, _, self.seam = self.fused_impls()
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
            self.front, self.resume = stem_conv, "stem"
            self.front_supported = lambda h, w: stem_supported(h)
        elif self.use_tail and not self.seam:
            pass  # cpool and s2d ride the seam tail kernel, which rowpack replaces
        elif self.use_tail and "cpool2" in stages:
            self.resume = "c21"
            self.front = (fused_conv12_pool_conv21_q if cfg.quant_int8
                          else fused_conv12_pool_conv21)
        elif self.use_tail and "cpool" in stages:
            self.resume = "pool"
            self.front = fused_conv12_pool
        elif self.use_tail and "s2d" in stages and dtype == torch.bfloat16:
            self.front, self.resume = fused_conv12_pool, "pool"
            self.prefix = lambda canvases: s2d_prefix(canvases, self.stem)
            self.s2d = True
        if explicit:
            warn_unhonoured(stages, self.use_tail, self.front, self.s2d)
        # the two stage functions, for per-stage timing (the JAX package's
        # _stage_fns under LIGHTLY_OCR_MONOLITH=0)
        self.stage_fns = (self.detector_scores, self.postprocess)
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
        self.lm = load_lm_prior(cfg, self.device)  # None without ctc_lm_path
        self.converter = build_converter(cfg.prediction, cfg.character)
        self._chartab = np.asarray(self.converter.character, dtype="<U1")
        # one replica of both networks on each further data-axis device,
        # each with a stream of its own (two replicas may share a card) and
        # a thread of one pool
        self.stream, self.pool = None, None
        self.replicas = [self] if mesh is None else [self] + [
            BatchedOCR(cfg, det_state, rec_state, boxes_per_image, dtype, device=d)
            for d in mesh.data_devices[1:]]
        if mesh is not None:
            for r in self.replicas:
                if r.device.type == "cuda":
                    r.stream = torch.cuda.Stream(r.device)
            self.pool = ThreadPoolExecutor(len(self.replicas), thread_name_prefix="replica")

    def close(self) -> None:
        """Shut down a mesh's replica threads (a mesh object serves no call
        after it); nothing to do without a mesh."""
        if self.pool is not None:
            self.pool.shutdown(wait=True)
            self.pool = None

    def detector_scores(self, canvases: torch.Tensor):
        """[B, H, W, 3] normalized canvases -> (region, affinity) f32
        [B, H/2, W/2] each, by the plan of the module docstring."""
        with annotate("ocr.detector"):
            if not self.use_tail:
                y, _ = self.det_net(canvases)
                return y[..., 0].float(), y[..., 1].float()
            front = self.front_for(*canvases.shape[1:3])
            if front is not None:
                with annotate("ocr.detector.prefix"):
                    x0 = self.prefix(canvases)
                trunk = self.det_net.trunk(front(x0, self.stem), resume=self.resume, seam=self.seam)
            else:
                trunk = self.det_net.trunk(canvases, seam=self.seam)
            if not self.seam:
                y = tail_scores_rowpacked(trunk, self.tail)  # [B, H2, W2, 2]
                return y[..., 0], y[..., 1]
            y = fused_tail_scores_cs_seam(self.tail, *trunk)  # [B, H2, 2, W2]
            return y[:, :, 0], y[:, :, 1]

    def fused_impls(self):
        """(stem conv, tail, whether the tail is the channels-second seam
        kernel) of ``fused_impl``: the hand kernels (#4, #1), or the
        row-packed stock convs of :mod:`..ops.rowpack` (the JAX package's
        ``_fused_impls``)."""
        if self.impl == "rowpack":
            return stem_conv_rowpacked, tail_scores_rowpacked, False
        return fused_stem_conv, fused_tail_scores_cs_seam, True

    def fused_kernel_plan(self, h: int, w: int) -> tuple:
        """(use_stem, use_tail, use_cpool, use_s2d) on an ``h x w`` canvas,
        as the JAX package's ``_fused_kernel_plan`` resolves them on its
        accelerator: ``use_cpool`` is False, ``"pool"`` or ``"c21"``."""
        front = self.front_for(h, w)
        use_cpool = {fused_conv12_pool: "pool", fused_conv12_pool_conv21: "c21",
                     fused_conv12_pool_conv21_q: "c21"}
        return (front in (fused_stem_conv, stem_conv_rowpacked), self.use_tail,
                False if self.s2d else use_cpool.get(front, False),
                self.s2d and front is not None)

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
        with annotate("ocr.boxes"):
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
            with annotate(SYNC):
                dummy = torch.tensor([0.0, 0.0, 1.0, 1.0], device=rects.device)
            return torch.where(valid[..., None], rects, dummy), valid

    def recognize(self, gray, rects):
        """gray [B, H0, W0] and rects [B, M, 4] -> (pred_idx [B, M, T],
        confidence [B, M] f32): bicubic crops, one CRNN dispatch over the
        B * M crops, the decode of ``cfg`` (with the LM prior, if any)."""
        B, M = rects.shape[:2]
        with annotate("ocr.recognize"):
            idx, conf = decode_crops(self.rec_net, self.crops(gray, rects), self.cfg, self.lm)
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

    def __call__(self, canvases, gray, inv_ratio, extents) -> dict:
        """canvases [B, H, W, 3] normalized; gray [B, H0, W0] ORIGINAL-
        resolution luma in [0, 255]; inv_ratio [B] = 1 / plan.ratio;
        extents [B, 2] true (h0, w0).  Rects come back in original-image
        coordinates.

        With a mesh, the batch must divide by its data axis: each contiguous
        chunk runs the whole program on its own replica, one thread per
        replica (the box extraction's host syncs of one replica then overlap
        the others' work), each under its device (the kernels launch on the
        calling thread's current device) and on its own stream (a sync waits
        for its replica's work alone); the outputs come back on the first
        device in batch order."""
        if self.mesh is None:
            return self.run(canvases, gray, inv_ratio, extents)
        shards = shard_batch((canvases, gray, inv_ratio, extents), self.mesh)
        # the streams that made the shards, for each replica to wait on
        made = [torch.cuda.current_stream(r.device) if r.stream is not None else None
                for r in self.replicas]
        futures = [self.pool.submit(r.run_on_device, m, *args)
                   for r, m, args in zip(self.replicas, made, shards)]
        outs = [f.result() for f in futures]
        return {k: torch.cat([o[k].to(self.device) for o in outs]) for k in outs[0]}

    def run_on_device(self, made, canvases, gray, inv_ratio, extents) -> dict:
        """:meth:`run` with this replica's device and stream made the
        current ones, after the work of ``made`` (the stream that made the
        inputs); returns once the outputs are computed."""
        if self.stream is None:
            return self.run(canvases, gray, inv_ratio, extents)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            self.stream.wait_stream(made)
            out = self.run(canvases, gray, inv_ratio, extents)
            self.stream.synchronize()
        return out

    @torch.inference_mode()
    def run(self, canvases, gray, inv_ratio, extents) -> dict:
        """The program on this device alone (the unsharded call)."""
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
        """One group's RGB images -> the arguments of :meth:`__call__` on
        the device, padded to a power-of-two batch, and to a multiple of
        the mesh's data axis (pad rows are blank canvases with a 1x1
        extent, so they yield no valid box).

        The host copies the images top-left into one zero-padded ``[B, H,
        W, 3]`` buffer (the group's largest extent; uint8, float32 where an
        image is not uint8) and the ratios and extents into another, both
        pinned for a card, and uploads each once without waiting for the
        card.  The card takes the luma into the gray bucket, resizes each
        run of consecutive images of one size in one call (the counter
        ``ocr.prepare.resize_batch``), pastes onto the canvases and
        normalizes them: the host never waits."""
        cfg, dev = self.cfg, self.device
        with annotate("ocr.prepare"):
            n = len(images)
            B = 1 << (n - 1).bit_length()
            r = len(self.replicas)  # a mesh's data axis must divide the batch
            B = -(-B // r) * r
            images = [np.asarray(image) for image in images]
            uint8 = all(image.dtype == np.uint8 for image in images)
            pinned = dev.type == "cuda"
            H = max(image.shape[0] for image in images)
            W = max(image.shape[1] for image in images)
            staged = torch.empty((B, H, W, 3), dtype=torch.uint8 if uint8 else torch.float32,
                                 pin_memory=pinned)
            meta = torch.ones(3 * B, dtype=torch.float32, pin_memory=pinned)
            host, m = staged.numpy(), meta.numpy()
            inv_ratios, extents = m[:B], m[B:].reshape(B, 2)
            host[n:] = 0
            runs = []  # (first, end, plan) of each run of one size
            for (h, w), run in itertools.groupby(range(n), key=lambda j: images[j].shape[:2]):
                run = list(run)
                plan = plan_aspect_resize(h, w, cfg.canvas_size, cfg.magnify_ratio,
                                          canvas_bucket=cb)
                for j in run:
                    host[j, :h, :w] = images[j]
                    host[j, h:] = 0
                    host[j, :h, w:] = 0
                inv_ratios[run] = 1.0 / plan.ratio
                extents[run] = (h, w)
                runs.append((run[0], run[-1] + 1, plan))
            x = staged.to(dev, non_blocking=True)
            meta = meta.to(dev, non_blocking=True)
            gray = torch.zeros((B, *gb), dtype=torch.float32, device=dev)
            gray[:, :H, :W] = rgb_to_gray(x)
            canv = torch.zeros((B, *cb, 3), dtype=torch.float32, device=dev)
            for a, b, plan in runs:
                h, w = images[a].shape[:2]
                th, tw = plan.target_h, plan.target_w
                canv[a:b, :th, :tw] = resize_bilinear(x[a:b, :h, :w], th, tw)
                count("ocr.prepare.resize_batch", b - a)
            canv[:n] = normalize_mean_variance(canv[:n])
            return canv, gray, meta[:B], meta[B:].view(B, 2)

    def run_images(self, images: list) -> list[list[dict]]:
        """RGB uint8 images of mixed sizes -> per image [{text, confidence,
        rect}], one dispatch per (canvas bucket, gray bucket) group."""
        results: list = [None] * len(images)
        for (cb, gb), idxs in self.group(images).items():
            with annotate("ocr.dispatch"):
                out = self(*self.prepare([images[i] for i in idxs], cb, gb))
                for i, items in zip(idxs, self.decode(out)):
                    results[i] = items
        return results

    def decode(self, out: dict) -> list[list[dict]]:
        """Device outputs -> per image [{text, confidence, rect}]; the
        character lookup, the CTC collapse and the EOS stops are vectorised
        over [B, M, T]."""
        with annotate("ocr.decode"):
            with annotate(SYNC):
                valid = out["valid"].cpu().numpy()
            with annotate(SYNC):
                idx = out["pred_idx"].cpu().numpy()
            with annotate(SYNC):
                conf = out["confidence"].cpu().numpy()
            with annotate(SYNC):
                rects = out["rects"].cpu().numpy()
            B, M, T = idx.shape
            ctc = self.cfg.prediction == "CTC"
            chars = np.ascontiguousarray(self._chartab[idx])
            if ctc and self.cfg.ctc_decode == "beam":
                # beam labels are final: drop the blank padding only (collapsing
                # again would eat genuine double letters)
                keep = idx != 0
            elif ctc:
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
