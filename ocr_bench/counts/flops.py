"""Operations of the work itself, counted once by ``FlopCounterMode`` on
the plain reference (so an MFU reads the same whatever implements the
work): a served receipt (the detector on its canvas, the recognizer on each
box that carried a word) and a training sample (forward and backward)."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ocr_bench.reference import craft, crnn


def serve_work(det_sd: dict, rec_sd: dict, rec_cfg: dict, canvas_hw: tuple) -> tuple[int, int]:
    """(the detector on one receipt's canvas, the recognizer on one box)."""
    dev = next(iter(det_sd.values())).device
    canvas = torch.zeros((1, *canvas_hw, 3), device=dev)
    crops = torch.zeros((1, rec_cfg["height"], rec_cfg["width"], 1), device=dev)
    fed = torch.zeros((1, rec_cfg["num_steps"]), dtype=torch.long, device=dev)
    with torch.no_grad(), FlopCounterMode(display=False) as det:
        craft.forward(det_sd, canvas)
    with torch.no_grad(), FlopCounterMode(display=False) as rec:
        crnn.CRNN(rec_sd, rec_cfg).forced_logits(crops, fed)
    return det.get_total_flops(), rec.get_total_flops()


def train_per_sample(rec_sd: dict, rec_cfg: dict, batch: int) -> float:
    dev = next(iter(rec_sd.values())).device
    sd = {k: v.detach().clone().requires_grad_(v.is_floating_point() and "running" not in k)
          for k, v in rec_sd.items()}
    images = torch.zeros((batch, rec_cfg["height"], rec_cfg["width"], 1), device=dev)
    text = torch.zeros((batch, rec_cfg["num_steps"] + 1), dtype=torch.long, device=dev)
    text[:, 1] = 1
    with FlopCounterMode(display=False) as fc:
        logits = crnn.CRNN(sd, rec_cfg, train=True).forced_logits(images, text[:, :-1])
        crnn.attention_loss(logits, text[:, 1:]).backward()
    return fc.get_total_flops() / batch
