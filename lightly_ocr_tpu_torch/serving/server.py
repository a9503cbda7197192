"""HTTP serving of the port: the same wire API as the JAX package's server
(port of ``lightly_ocr_tpu/serving/server.py``; reference ``ocr/server.py``).

* ``GET /``     -> 200 ``{"status": "online"}``
* ``POST /api`` -> 200 ``{"status": "OK", "results": {i: text}}``; 403
  ``{"status": "noInput"|"emptyInput"}``; 404 ``{"status": "badInput"}``
  (an extension other than png/jpeg/jpg, or an image that does not decode);
  503 ``{"status": "overloaded"}`` with ``Retry-After`` when the request
  queue is full; 504 ``{"status": "timeout"}`` past the request deadline,
  which also cancels the queued request.

The app is a plain WSGI callable served by ``wsgiref``'s threaded server.
Concurrent requests funnel into an :class:`InferenceWorker`, which batches
them for the model: the per-image ``pipeline.serveModel`` (float32 engines),
or with ``--batched`` :class:`BatchedServeModel` over ``BatchedOCR`` (bf16,
int8 by default as in the JAX CLI).  Uploads decode with PIL where it is
installed and, where it is not (the card), PNG only
(:mod:`lightly_ocr_tpu_torch.serving.upload`).  The server runs on the card
unless ``--device cpu`` is given.

    python -m lightly_ocr_tpu_torch.serving.server --batched --bf16 --decode beam
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import logging
import os
import queue
import re
import threading
import time
import uuid
from concurrent.futures import Future
from socketserver import ThreadingMixIn
from typing import Callable
from wsgiref.simple_server import WSGIServer, make_server

import numpy as np
import torch

from lightly_ocr_tpu_torch.serving.upload import decode_upload
from lightly_ocr_tpu_torch.utils.profiling import count

ALLOWED_EXT = {"png", "jpeg", "jpg"}
log = logging.getLogger("lightly_ocr_tpu_torch.server")


def is_allowed(filename: str) -> bool:
    return "." in filename and filename.rsplit(".", 1)[1].lower() in ALLOWED_EXT


def secure_filename(name: str) -> str:
    name = os.path.basename(name.replace("\\", "/"))
    name = re.sub(r"[^A-Za-z0-9_.-]", "_", name).strip("._")
    return name or f"upload-{uuid.uuid4().hex}"


class QueueFullError(RuntimeError):
    """Raised by :meth:`InferenceWorker.submit` when the request queue is
    at ``max_queue`` depth (load shedding instead of unbounded growth)."""


class InferenceWorker:
    """Single consumer thread that drains the request queue in batches of
    up to ``max_batch``; ``max_queue=0`` makes the queue unbounded.

    Counters (:func:`~lightly_ocr_tpu_torch.utils.profiling.counter_values`):
    ``worker.queue_wait_s``, a request's seconds from :meth:`submit` to the
    moment its batch is taken, and ``worker.batch_size``, the requests of
    each batch taken."""

    def __init__(self, predict_fn: Callable, max_batch: int = 16,
                 max_queue: int = 64):
        self.predict_fn = predict_fn
        self.max_batch = max_batch
        # (image, future, submit time)
        self.q: "queue.Queue[tuple[np.ndarray, Future, float]]" = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, image: np.ndarray) -> Future:
        fut: Future = Future()
        try:
            self.q.put_nowait((image, fut, time.perf_counter()))
        except queue.Full:
            raise QueueFullError(
                f"inference queue at max depth ({self.q.maxsize})"
            ) from None
        return fut

    def close(self) -> None:
        self._stop.set()
        # the sentinel only wakes an idle loop; a draining loop re-checks
        # _stop on its own, so a full queue may skip it
        try:
            self.q.put_nowait((None, None, 0.0))
        except queue.Full:
            pass
        self.thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = self.q.get(timeout=0.25)
            except queue.Empty:
                continue
            if item[0] is None:
                continue
            candidates = [item]
            while len(candidates) < self.max_batch:
                try:
                    nxt = self.q.get_nowait()
                except queue.Empty:
                    break
                if nxt[0] is not None:
                    candidates.append(nxt)
            # skip requests cancelled while queued; after
            # set_running_or_notify_cancel() a late cancel() cannot race
            # the set_result below
            batch = [c for c in candidates if c[1].set_running_or_notify_cancel()]
            if not batch:
                continue
            taken = time.perf_counter()
            for b in batch:
                count("worker.queue_wait_s", taken - b[2])
            count("worker.batch_size", len(batch))
            futures = [b[1] for b in batch]
            try:
                results = self.predict_fn([b[0] for b in batch])
                for fut, res in zip(futures, results):
                    fut.set_result(res)
            except Exception as e:  # surface errors to every waiter
                log.exception("batch inference failed")
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(e)


def _json_response(start_response, status: str, payload: dict,
                   extra_headers: list | None = None) -> list[bytes]:
    body = json.dumps(payload).encode()
    start_response(status, [("Content-Type", "application/json"),
                            ("Content-Length", str(len(body)))] + (extra_headers or []))
    return [body]


def _parse_multipart(environ) -> tuple[str | None, bytes | None]:
    """(filename, bytes) of the ``file`` field of a multipart form; (None,
    None) if absent."""
    ctype = environ.get("CONTENT_TYPE", "")
    m = re.search(r'boundary="?([^";]+)"?', ctype)
    if "multipart/form-data" not in ctype or not m:
        return None, None
    boundary = m.group(1).encode()
    try:
        length = int(environ.get("CONTENT_LENGTH") or 0)
    except ValueError:
        return None, None
    body = environ["wsgi.input"].read(length)
    for part in body.split(b"--" + boundary):
        if b"Content-Disposition" not in part:
            continue
        header_blob, _, content = part.partition(b"\r\n\r\n")
        header = header_blob.decode("utf-8", "replace")
        if 'name="file"' not in header:
            continue
        fn = re.search(r'filename="([^"]*)"', header)
        return (fn.group(1) if fn else ""), content.rstrip(b"\r\n-")
    return None, None


def create_app(model, upload_folder: str = "test", worker: InferenceWorker | None = None,
               request_timeout_s: float | None = None):
    """WSGI app around a ``serveModel``-compatible object (``predict(image)
    -> [text]``); without ``worker``, an :class:`InferenceWorker` over
    ``model.predict``.  Each upload is saved to ``upload_folder`` under a
    sanitised name, decoded (:func:`decode_upload`) and queued.  A full
    queue answers 503 with ``Retry-After: 1``; a result that does not land
    within ``request_timeout_s`` (default: ``LIGHTLY_OCR_REQUEST_TIMEOUT_S``
    or 30 s) answers 504 and cancels the request, so the worker skips it if
    it is still queued."""
    if request_timeout_s is None:
        request_timeout_s = float(os.environ.get("LIGHTLY_OCR_REQUEST_TIMEOUT_S", "30"))
    os.makedirs(upload_folder, exist_ok=True)
    if worker is None:
        worker = InferenceWorker(lambda images: [model.predict(img) for img in images])

    def app(environ, start_response):
        method = environ.get("REQUEST_METHOD", "GET")
        path = environ.get("PATH_INFO", "/")

        if path == "/" and method == "GET":
            log.info("ping received")
            return _json_response(start_response, "200 OK", {"status": "online"})

        if path == "/api" and method == "POST":
            filename, content = _parse_multipart(environ)
            if filename is None:
                log.warning("no image field in request")
                return _json_response(start_response, "403 FORBIDDEN", {"status": "noInput"})
            if filename == "" or not content:
                log.warning("empty upload")
                return _json_response(start_response, "403 FORBIDDEN", {"status": "emptyInput"})
            if not is_allowed(filename):
                log.error("file type not accepted: %s", filename)
                return _json_response(start_response, "404 NOT FOUND", {"status": "badInput"})
            with open(os.path.join(upload_folder, secure_filename(filename)), "wb") as f:
                f.write(content)
            try:
                image = decode_upload(content)
            except Exception as e:  # any undecodable upload is the client's
                log.warning("upload %s does not decode: %s", filename, e)
                return _json_response(start_response, "404 NOT FOUND", {"status": "badInput"})
            try:
                fut = worker.submit(image)
            except QueueFullError:
                log.warning("shedding load: inference queue full")
                return _json_response(start_response, "503 SERVICE UNAVAILABLE",
                                      {"status": "overloaded"},
                                      extra_headers=[("Retry-After", "1")])
            try:
                results = fut.result(timeout=request_timeout_s)
            except concurrent.futures.TimeoutError:
                # the deadline bounds the work, not only the wait
                fut.cancel()
                log.warning("request timed out after %.1fs", request_timeout_s)
                return _json_response(start_response, "504 GATEWAY TIMEOUT", {"status": "timeout"})
            except concurrent.futures.CancelledError:
                return _json_response(start_response, "504 GATEWAY TIMEOUT", {"status": "timeout"})
            return _json_response(start_response, "200 OK", {
                "status": "OK", "results": {i: t for i, t in enumerate(results)}})

        return _json_response(start_response, "404 NOT FOUND", {"status": "notFound"})

    app.worker = worker
    return app


class BatchedServeModel:
    """serveModel-compatible wrapper over :class:`BatchedOCR`.

    Builds the per-image engines (``engines.CRAFT``/``CRNN``, which read
    ``CRAFT.pth``/``CRNN.pth`` from ``config.pretrained`` or fall back to
    seeded random weights) and serves their weights batched, as the JAX
    package's ``BatchedServeModel`` does.  ``det_state``/``rec_state``
    override the detector's and recognizer's weights with state dicts."""

    def __init__(self, config=None, thresh: float = 0.7,
                 boxes_per_image: int = 32, *, det_state: dict | None = None,
                 rec_state: dict | None = None, device="cuda",
                 dtype: torch.dtype = torch.bfloat16):
        from lightly_ocr_tpu_torch.config import Config
        from lightly_ocr_tpu_torch.engines import CRAFT, CRNN
        from lightly_ocr_tpu_torch.serving.batch import BatchedOCR, resolve_device

        device = resolve_device(device)
        self.config = config or Config()
        self.thresh = float(thresh)
        det = CRAFT(self.config, state_dict=det_state, device=device)
        rec = CRNN(self.config, state_dict=rec_state, device=device)
        self.detector, self.recognizer = det, rec
        self.ocr = BatchedOCR(self.config, det.state_dict, rec.state_dict,
                              boxes_per_image=boxes_per_image, dtype=dtype,
                              device=device)

    def predict_many(self, images: list) -> list[list[str]]:
        res = self.ocr.run_images([np.asarray(img) for img in images])
        return [
            [it["text"] for it in items if it["confidence"] > self.thresh]
            for items in res
        ]

    def predict(self, image) -> list[str]:
        return self.predict_many([image])[0]


class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    """``wsgiref``'s server with a thread per request.  The listen backlog
    is raised from ``socketserver``'s 5: in a burst of concurrent uploads
    the kernel drops the connections beyond it, and each of those clients
    waits out a one-second SYN retransmit."""

    daemon_threads = True
    request_queue_size = 128


def served_plan(model) -> str:
    """One line naming what a model serves: program, dtype, plan, decode."""
    cfg = model.config
    if isinstance(model, BatchedServeModel):
        dtype = str(model.ocr.dtype).replace("torch.", "")
        plan = (f"batched {dtype}{' int8' if cfg.quant_int8 else ''} "
                f"fused_stages={cfg.fused_stages}")
    else:
        plan = "per-image float32 engines"
    head = cfg.prediction
    decode = cfg.ctc_decode if head == "CTC" else cfg.attn_decode
    beam = f" beam_width={cfg.beam_width}" if decode == "beam" else ""
    lm = f" lm={cfg.ctc_lm_path}" if cfg.ctc_lm_path else ""
    return f"{plan}, {head} {decode}{beam}{lm}"


def run_server(host: str = "0.0.0.0", port: int = 5000, config_file=None,
               thresh: float = 0.7, config=None, batched: bool = False,
               request_timeout_s: float | None = None, device="cuda"):
    """Build the model on ``device`` and serve it until interrupted; prints
    ``serving on {host}:{port}`` with the bound port (``port=0`` binds a
    free one)."""
    from lightly_ocr_tpu_torch.config import load_config
    from lightly_ocr_tpu_torch.pipeline import serveModel

    cfg = config or load_config(config_file)
    if batched:
        model = BatchedServeModel(config=cfg, thresh=thresh, device=device)
        worker = InferenceWorker(model.predict_many)
    else:
        model = serveModel(config_file=config_file, thresh=thresh, config=cfg, device=device)
        worker = None
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host CPU"
    log.info("device %s (%s); %s", dev, name, served_plan(model))
    app = create_app(model, worker=worker, request_timeout_s=request_timeout_s)
    httpd = make_server(host, port, app, server_class=ThreadingWSGIServer)
    print(f"serving on {host}:{httpd.server_port}", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        app.worker.close()


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description="OCR server (PyTorch port)")
    parser.add_argument("--docker", action="store_true",
                        help="accepted for reference CLI compat (no-op)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--thresh", type=float, default=0.7)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--batched", action="store_true",
                        help="route concurrent requests through the batched "
                             "serving program (BatchedOCR, bf16)")
    parser.add_argument("--int8", dest="int8", action="store_true", default=None,
                        help="w8a8 int8 backbone convs; on by default as in the JAX "
                             "package's CLI; a --config file's quant_int8 wins "
                             "unless a flag is typed")
    parser.add_argument("--bf16", dest="int8", action="store_false",
                        help="disable int8: bf16 backbone convs")
    parser.add_argument("--decode", choices=["greedy", "beam"], default=None,
                        help="decode of the active head (sets ctc_decode or "
                             "attn_decode); beam returns sequence posteriors "
                             "as confidences")
    parser.add_argument("--beam-width", type=int, default=None)
    parser.add_argument("--request-timeout", type=float, default=None, metavar="SECONDS",
                        help="per-request inference deadline before a 504 "
                             "(default: LIGHTLY_OCR_REQUEST_TIMEOUT_S or 30)")
    parser.add_argument("--lm", default=None, metavar="PRIOR_NPY",
                        help="shallow-fusion LM prior: a charset-space .npy "
                             "transition log-prior (scripts/build_lm_prior.py); "
                             "CTC needs --decode beam, the Attention head fuses "
                             "it in greedy and beam decode (sets ctc_lm_path)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default cuda; cpu without a card)")
    opt = parser.parse_args(argv)
    from dataclasses import replace

    from lightly_ocr_tpu_torch.config import load_config

    cfg = load_config(opt.config)
    if opt.int8 is not None:
        cfg = replace(cfg, quant_int8=opt.int8)  # an explicit flag wins
    elif opt.config is None:
        cfg = replace(cfg, quant_int8=True)  # no config: the int8 default
    if opt.decode is not None:
        key = "ctc_decode" if cfg.prediction == "CTC" else "attn_decode"
        cfg = replace(cfg, **{key: opt.decode})
    if opt.beam_width is not None:
        cfg = replace(cfg, beam_width=opt.beam_width)
    if opt.lm is not None:
        cfg = replace(cfg, ctc_lm_path=opt.lm)
    run_server(opt.host, opt.port, opt.config, opt.thresh, config=cfg, batched=opt.batched,
               request_timeout_s=opt.request_timeout, device=opt.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
