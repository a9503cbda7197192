"""The served program under load: ``InferenceWorker(max_batch)`` over
``BatchedOCR.run_images`` (the call ``BatchedServeModel.predict_many``
makes, with the rects and confidences kept), on seeded weights and a seeded
pool of receipts.

The benchmark's glue is the worker's ``predict_fn``: it hands the batch to
``run_images`` and notes when each dispatch starts and ends.  Receipts are
submitted as views of the pool's arrays, one view a request, so the glue
knows which requests a batch carries without copying an image.  For the
check of ``correct`` the glue keeps, of a few dispatches drawn from the
seed, the program's own outputs: its score maps (the output of
``BatchedOCR.detector_scores``), the recognizer's logits (a forward hook),
its device outputs (rects, valid flags, tokens, confidences) and the
answers it served.
"""
from __future__ import annotations

import gc
import threading
import time

import numpy as np
import torch

from ocr_bench import gen, weights
from ocr_bench.reference import craft, crnn


class Request:
    __slots__ = ("pid", "image", "client", "due", "sent", "start", "done", "boxes", "future")

    def __init__(self, pid, image, client, due):
        self.pid, self.image, self.client, self.due = pid, image, client, due
        self.sent = self.start = self.done = self.boxes = None
        self.future = None


class Warmup:
    """A job the glue runs in the worker's thread: ``run_images`` on
    batches of each size, so that every shape the cell uses is built there
    before the window."""

    def __init__(self, sizes):
        self.sizes = sizes


def rec_cfg(cfg) -> dict:
    """The recognizer's sizes as the reference takes them."""
    return {"num_fiducial": cfg.num_fiducial, "height": cfg.height, "width": cfg.width,
            "input_channel": cfg.derived_input_channel, "output_channel": cfg.output_channel,
            "hidden_size": cfg.hidden_size, "num_classes": cfg.derived_num_classes,
            "num_steps": cfg.num_steps}


def make_weights(cfg, seed: int, device, head: dict | None = None, receipts=None,
                 cfgd: dict | None = None) -> tuple[dict, dict]:
    """(detector, recognizer) state dicts from the seed; with ``head``, the
    detector's last 1x1 conv is set as ``calibrate_head`` says."""
    det_spec = craft.param_spec()
    spec = det_spec + crnn.param_spec(rec_cfg(cfg))
    sd = weights.make(spec, seed, device, crnn.fiducials(cfg.num_fiducial))
    det = {k: sd[k] for k, _, _ in det_spec}
    if head is not None:
        calibrate_head(det, head, receipts, cfgd)
    return det, {k: v for k, v in sd.items() if k not in det}


def calibrate_head(det: dict, head: dict, receipts: list, cfgd: dict) -> None:
    """Random weights score every pixel of a receipt alike, far above or
    far below the thresholds, so their maps hold one box or none.  Here the
    last 1x1 conv keeps its seeded directions, and each score channel is
    scaled and shifted so that, over the first ``head["receipts"]``
    receipts of the pool, its quantile q1 scores s1 and q2 scores s2
    (``head[channel] = [[q1, s1], [q2, s2]]``; the reference computes the
    16 channels the conv maps, in float32): a minority of pixels, in
    clusters, then passes the thresholds, as on a trained detector's maps."""
    from ocr_bench.reference import prep
    from ocr_bench.reference.common import float32_exact

    dev = det["conv_cls.8.weight"].device
    canv = torch.stack([prep.detector_canvas(im, cfgd, dev)[0] for im in receipts[: int(head["receipts"])]])
    with torch.no_grad(), float32_exact():
        h = craft.head_input(det, canv)  # [n, 16, H/2, W/2]
        w = det["conv_cls.8.weight"][:, :, 0, 0]
        proj = torch.einsum("oc,nchw->onhw", w, h).flatten(1).sort(1).values
        scale, shift = [], []
        for ch, key in enumerate(("region", "affinity")):
            (q1, s1), (q2, s2) = head[key]
            v1, v2 = (proj[ch, min(int(q * proj.shape[1]), proj.shape[1] - 1)] for q in (q1, q2))
            scale.append((s2 - s1) / (v2 - v1))
            shift.append(s1 - v1 * scale[-1])
        scale, shift = torch.stack(scale), torch.stack(shift)
        det["conv_cls.8.weight"] = (w * scale[:, None])[:, :, None, None].contiguous()
        det["conv_cls.8.bias"] = shift.contiguous()


SPANS = ("group", "prepare", "detector_scores", "boxes", "recognize", "decode")


class Served:
    def __init__(self, ctx):
        from lightly_ocr_tpu_torch.config import Config
        from lightly_ocr_tpu_torch.serving.batch import BatchedOCR
        from lightly_ocr_tpu_torch.serving.server import InferenceWorker

        tr = ctx.traffic
        self.ctx = ctx
        self.cfg = Config.from_dict(ctx.config)
        self.device = torch.device(ctx.device)
        rng = np.random.default_rng(ctx.seed)
        self.pool = gen.receipts(rng, int(tr["pool"]), int(tr["receipt_h"]), int(tr["receipt_w"]))
        self.det_sd, self.rec_sd = make_weights(self.cfg, ctx.seed, self.device,
                                                ctx.config.get("detector_head"), self.pool, ctx.config)
        self.order = rng.integers(0, len(self.pool), size=1 << 16)
        # dispatches of the window whose outputs the check reads
        self.capture_at = set(rng.choice(int(tr["sample_from"]), int(tr["sample_dispatches"]),
                                          replace=False).tolist())
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[ctx.config["precision"]]
        self.ocr = BatchedOCR(self.cfg, self.det_sd, self.rec_sd,
                              boxes_per_image=int(ctx.config["boxes_per_image"]), dtype=dtype,
                              device=self.device)
        self.canvas = None
        self._wrap(ctx.trace)
        self.run_images = (_span("ocr_bench.dispatch", self.ocr.run_images) if ctx.trace
                           else self.ocr.run_images)
        self.lock = threading.Lock()
        self.requests: list[Request] = []
        self.dispatches: list[tuple] = []  # (start, end, receipts, canvas shape)
        self.captured: list[dict] = []
        self.capturing = None
        self.n_dispatch = 0
        self.by_view: dict[int, Request] = {}
        self.worker = InferenceWorker(self.predict, max_batch=int(tr["max_batch"]), max_queue=0)

    def _wrap(self, spans: bool) -> None:
        """Capture wrappers always; ``record_function`` spans around the
        program's stages only in a traced run."""
        ocr = self
        scores, decode, prepare = self.ocr.detector_scores, self.ocr.decode, self.ocr.prepare

        def detector_scores(canvases):
            out = scores(canvases)
            if ocr.capturing is not None:
                ocr.capturing["maps"] = out
            return out

        def decode_(out):
            if ocr.capturing is not None:
                ocr.capturing["out"] = out
            return decode(out)

        def prepare_(images, cb, gb):
            ocr.canvas = (len(images), *cb)
            return prepare(images, cb, gb)

        self.ocr.detector_scores, self.ocr.decode, self.ocr.prepare = detector_scores, decode_, prepare_

        def logits(_module, _args, out):
            if ocr.capturing is not None:
                ocr.capturing["logits"] = out
        self.ocr.rec_net.register_forward_hook(logits)
        if spans:
            for name in SPANS:
                fn = getattr(self.ocr, name)
                setattr(self.ocr, name, _span(f"ocr_bench.{name}", fn))
            traced_scores = self.ocr.detector_scores

            def shaped_scores(canvases):
                # the canvas batch, for the kernels' rooflines
                B, H, W = canvases.shape[:3]
                with torch.profiler.record_function(f"ocr_bench.shape.{B}x{H}x{W}"):
                    return traced_scores(canvases)

            self.ocr.detector_scores = shaped_scores

    def predict(self, images: list) -> list:
        if isinstance(images[0], Warmup):
            for n in images[0].sizes:
                self.ocr.run_images([self.pool[i % len(self.pool)] for i in range(n)])
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            return [None] * len(images)
        t0 = time.perf_counter()
        reqs = [self.by_view[id(im)] for im in images]
        for r in reqs:
            r.start = t0
        k = self.n_dispatch
        self.n_dispatch += 1
        self.capturing = {"pids": [r.pid for r in reqs]} if k in self.capture_at else None
        results = self.run_images(images)
        if self.capturing is not None:
            self.capturing["results"] = results
            self.captured.append(self.capturing)
            self.capturing = None
        self.dispatches.append((t0, time.perf_counter(), len(images), self.canvas))
        return results

    def submit(self, pid: int, client: int, due: float, then=None) -> Request:
        """Queue pool receipt ``pid``; ``then(req)`` runs in the worker's
        thread once the answer is set."""
        view = self.pool[pid].view()
        req = Request(pid, view, client, due)
        with self.lock:
            self.by_view[id(view)] = req
            self.requests.append(req)
        req.sent = time.perf_counter()
        req.future = self.worker.submit(view)
        req.future.add_done_callback(on_done(req, then))
        return req

    def warm(self, sizes) -> None:
        self.worker.submit(Warmup(sizes)).result(timeout=1200)

    def settle(self, timeout: float = 90.0) -> None:
        """Wait for every submitted request's answer (one that never
        comes stays unanswered and fails the run)."""
        end = time.perf_counter() + timeout
        for r in list(self.requests):
            try:
                r.future.result(timeout=max(0.0, end - time.perf_counter()))
            except Exception:  # noqa: BLE001 - an answer that never comes counts as failed
                pass

    def close(self) -> None:
        self.worker.close()
        if self.worker.thread.is_alive():
            raise RuntimeError("the inference worker did not stop")


def _span(name, fn):
    """``fn`` inside a ``record_function`` span ``name``."""
    def wrapped(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return wrapped


def on_done(req: Request, then=None):
    """A done-callback that stamps the answer's time (and runs ``then``)."""
    def cb(fut):
        req.done = time.perf_counter()
        if fut.exception() is None:
            req.boxes = len(fut.result())  # the box slots that carried a word
        if then is not None:
            then(req)
    return cb


def finish(ctx, served: Served, t0: float, t1: float, traced) -> dict:
    """After the window: read the peak memory, stop the worker, free the
    program, then run the check on what the kept dispatches served."""
    from ocr_bench import check_serving
    from ocr_bench.counts import flops

    cuda = served.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    served.close()
    reqs = served.requests
    failed = sum(1 for r in reqs if r.done is None or r.future.exception() is not None)
    records = {"window": (t0, t1), "traced": traced,
               "dispatches": list(served.dispatches),
               "requests": [(r.due, r.start, r.done, r.boxes) for r in reqs]}
    captured, pool, cfg = served.captured, served.pool, served.cfg
    det_sd, rec_sd = served.det_sd, served.rec_sd
    served.ocr = served.worker = None
    served.by_view.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rcfg = rec_cfg(cfg)
    nums = check_serving.check(captured, pool, det_sd, rec_sd, ctx.config, rcfg)
    control = (check_serving.check(captured, pool, det_sd, rec_sd, ctx.config, rcfg, control=True)
               if ctx.control else None)
    if traced is not None:
        canvas = records["dispatches"][0][3][1:]
        records["flops_detector"], records["flops_per_box"] = flops.serve_work(det_sd, rec_sd, rcfg, canvas)
    want = int(ctx.traffic["sample_dispatches"])
    return {"attempted": len(reqs), "failed": failed, "memory_peak_bytes": peak,
            "records": records, "numbers": nums, "control": control,
            "complete": len(captured) == want and nums["served_steps"] > 0,
            "why_incomplete": f"{len(captured)} of {want} sampled dispatches kept, "
                              f"{nums['served_steps']} served steps"}
