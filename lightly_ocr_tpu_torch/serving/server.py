"""Request batching in front of :class:`BatchedOCR` (port of the batched
half of ``lightly_ocr_tpu/serving/server.py``).

:class:`InferenceWorker` drains a bounded request queue in batches on one
consumer thread; :class:`BatchedServeModel` answers each batch through
:meth:`BatchedOCR.run_images`.  The WSGI front end (``create_app``,
``run_server``), which decodes uploads with PIL, is not ported yet.
"""
from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import Future
from typing import Callable

import numpy as np
import torch

log = logging.getLogger("lightly_ocr_tpu_torch.server")


class QueueFullError(RuntimeError):
    """Raised by :meth:`InferenceWorker.submit` when the request queue is
    at ``max_queue`` depth (load shedding instead of unbounded growth)."""


class InferenceWorker:
    """Single consumer thread that drains the request queue in batches of
    up to ``max_batch``; ``max_queue=0`` makes the queue unbounded."""

    def __init__(self, predict_fn: Callable, max_batch: int = 16,
                 max_queue: int = 64):
        self.predict_fn = predict_fn
        self.max_batch = max_batch
        self.q: "queue.Queue[tuple[np.ndarray, Future]]" = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, image: np.ndarray) -> Future:
        fut: Future = Future()
        try:
            self.q.put_nowait((image, fut))
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
            self.q.put_nowait((None, None))
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


class BatchedServeModel:
    """serveModel-compatible wrapper over :class:`BatchedOCR`.

    ``det_state``/``rec_state`` are the detector's and recognizer's state
    dicts (the port has no checkpoint loader yet; see
    :func:`lightly_ocr_tpu_torch.weights.state_dict_from_variables`)."""

    def __init__(self, config=None, thresh: float = 0.7,
                 boxes_per_image: int = 32, *, det_state: dict, rec_state: dict,
                 device="cuda", dtype: torch.dtype = torch.bfloat16):
        from lightly_ocr_tpu_torch.config import Config
        from lightly_ocr_tpu_torch.serving.batch import BatchedOCR

        self.config = config or Config()
        self.thresh = float(thresh)
        self.ocr = BatchedOCR(self.config, det_state, rec_state,
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
