"""End-to-end OCR pipeline of the port: detect -> crop -> recognize.

Port of ``lightly_ocr_tpu/pipeline.py`` (reference ``ocr/pipeline.py``):
``prepModel``, ``getText``, ``get_text_detailed``, ``serveModel``,
``calcTime`` and the CLI (``--config/--thresh/--img/--debug``), with the
same choices as the JAX package: the crops of an image go to the
recognizer in one dispatch, images are read as RGB, and ``--debug`` does not
pick the device.  The device is explicit: ``device="cuda"`` by default and
``--device`` on the command line (``cpu`` for a machine without a card).

    python -m lightly_ocr_tpu_torch.pipeline --img receipt.png --device cpu
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Sequence

import numpy as np

from lightly_ocr_tpu_torch.config import Config, load_config
from lightly_ocr_tpu_torch.engines import CRAFT, CRNN, gray_from_rgb


def read_image(path: str) -> np.ndarray:
    """RGB uint8 [H, W, 3] via PIL (drops alpha, grayscale -> RGB).  PIL is
    imported here only: the serving path runs without it."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def prepModel(config: Config | None = None, docker: bool = False, device="cuda"):
    """Construct (detector, recognizer) per ``config.pipeline``
    (``pipeline.py:47-62``)."""
    cfg = config or Config()
    use_detector, use_recognizer = cfg.pipeline.split("-")
    if use_detector != "CRAFT":
        raise AssertionError(f"only CRAFT is supported, got {use_detector}")
    if use_recognizer != "CRNN":
        raise AssertionError(f"only CRNN is supported, got {use_recognizer}")
    return CRAFT(cfg, device=device), CRNN(cfg, device=device)


def _read(image: np.ndarray, detector: CRAFT, recognizer: CRNN):
    rects = detector.detect_rects(image)
    texts, confs = recognizer.process_batch(gray_from_rgb(image), rects)
    return rects, texts, confs


def getText(image: str | np.ndarray, detector: CRAFT, recognizer: CRNN,
            write: bool = False, out_dir: str = "test") -> dict[float, str]:
    """Detect + recognize one receipt -> {confidence: text}
    (``pipeline.py:65-87`` result shape)."""
    if isinstance(image, str):
        image = read_image(image)
    _, texts, confs = _read(image, detector, recognizer)
    res = {float(c): t for c, t in zip(confs, texts)}
    if write:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "results.txt"), "w") as f:
            for k, v in res.items():
                f.write(f"confidence: {k}\tprediction: {v}\n")
    return res


def get_text_detailed(image: np.ndarray, detector: CRAFT,
                      recognizer: CRNN) -> list[dict[str, Any]]:
    """Structured variant: reading-order [{text, confidence, rect}]."""
    rects, texts, confs = _read(image, detector, recognizer)
    return [{"text": t, "confidence": float(c), "rect": r.tolist()}
            for t, c, r in zip(texts, confs, rects)]


class serveModel:
    """Reference-compatible serving wrapper (``pipeline.py:90-112``)."""

    def __init__(self, config_file: str | None = None, thresh: float = 0.7,
                 docker: bool = False, config: Config | None = None, device="cuda"):
        self.config_file = config_file
        self.thresh = float(thresh)
        self.docker = docker
        self.device = device
        self.config = config or load_config(config_file)
        self.loadModel()

    def loadConfig(self) -> None:
        self.config = load_config(self.config_file)

    def loadModel(self) -> None:
        self.detector, self.recognizer = prepModel(self.config, self.docker, self.device)

    def predict(self, inputs: str | np.ndarray) -> list[str]:
        res = getText(inputs, self.detector, self.recognizer)
        return [v for k, v in res.items() if k > self.thresh]

    def predict_detailed(self, inputs: str | np.ndarray):
        if isinstance(inputs, str):
            inputs = read_image(inputs)
        items = get_text_detailed(inputs, self.detector, self.recognizer)
        return [it for it in items if it["confidence"] > self.thresh]


def calcTime(fn, *args, **kwargs):
    """Micro-bench helper (``pipeline.py:40-43``) -> (result, seconds)."""
    start = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - start


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="OCR pipeline (PyTorch port)")
    parser.add_argument("--config", default=None,
                        help="path to config.yml (defaults built in)")
    parser.add_argument("--thresh", type=float, default=0.7,
                        help="confidence threshold")
    parser.add_argument("--img", required=True, help="image to OCR")
    parser.add_argument("--debug", action="store_true",
                        help="print per-box details and timings")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu without a card)")
    opt = parser.parse_args(argv)

    # fail fast before the (slow) model build
    if not os.path.isfile(opt.img):
        parser.error(f"image not found: {opt.img}")
    if opt.config is not None and not os.path.isfile(opt.config):
        parser.error(f"config not found: {opt.config}")

    model = serveModel(config_file=opt.config, thresh=opt.thresh, device=opt.device)
    if opt.debug:
        items, dt = calcTime(model.predict_detailed, opt.img)
        for it in items:
            print(f"{it['rect']}\t{it['confidence']:.4f}\t{it['text']}")
        print(f"[debug] end-to-end: {dt:.3f}s ({len(items)} boxes)")
    else:
        for text in model.predict(opt.img):
            print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
