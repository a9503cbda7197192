#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its seconds; any failed check raises and the script
exits non-zero with the traceback):

1. build the CUDA kernels from ``lightly_ocr_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together), load them with ``ctypes`` and check
   the tail kernel's strip / segment / halo against ``ops/seam_tail.py`` and
   the conv1_2 kernel's (``conv3x3_hopper``) against ``ops/stem.py``;
2. seam-tail kernel (#1) vs its plain PyTorch version at the serving shapes
   (batch 16, 960x640 canvas -> 480x320 maps) on the port's own trunk
   output, plus the same chain as ``F.conv2d`` calls as a yardstick; then
   the tail chain alone (#3, the legacy pad+kernel tail) vs its plain
   version on the 64-channel activation formed from the same trunk output;
3. connected-components kernel vs its plain version, labels exactly equal,
   on the phase-2 foreground masks, a 480x320 adversarial spiral and comb,
   and a batch of 16 480x320 random masks at the percolation threshold;
   timed around the wrapper and from a CUDA graph (the device alone), and
   its three launches (strip, seams, flatten) split on the device's clock;
4. the fused conv1_2 front (``csrc/stem.cu``): kernels #4 (conv1_2 at full
   resolution), #5 (conv1_2 + pool), #6 (+ conv2_1) and #7 (w8a8 #6), each
   vs its plain version on the served model's own conv1_1 activation of the
   receipts (batch 16, 960x640), #7 also vs the float #6 chain; each timed
   beside its bound, its plain version and the cuDNN bf16 chain (for #7,
   which has no PyTorch counterpart, only for scale); and #7's launches
   timed one by one;
5. one dispatch of each other serving plan (bf16 ``tail,cpool``, bf16
   ``tail,cpool2``, int8 ``tail,s2d``, bf16 ``tail,stem``, and bf16
   ``tail,s2d`` with ``LIGHTLY_OCR_TAIL_SEAMK=0``) on the same receipts,
   each checked for its kernels (or, for int8 ``s2d``, for its int8 convs)
   and compared with the bf16 default plan (printed; the ``SEAMK=0`` plan,
   which runs #3 in place of the seam kernel, is also gated);
6. end to end: ``BatchedServeModel.predict_many`` behind an
   ``InferenceWorker`` answers batches of synthetic 600x400 receipts at the
   full model width (VGG16-BN CRAFT; TPS + ResNet(512) + BiLSTM(256) +
   Attention; 32 boxes per receipt; random weights from a seed), in bf16
   with the default plan (kernel #5, seam tail and CC must launch), in
   bf16 ``tail,stem`` (kernel #4, seam tail and CC must launch), and in the
   int8 ``tail,cpool2`` plan (kernel #7, seam tail and CC must launch); at
   least one receipt must get a box in each;
7. a per-stage breakdown of one dispatch of each of the three served plans;
8. ``engines``: the per-image path a user reads real checkpoints with.  The
   same random full-width weights (CRAFT; CRNN with TPS and Attention) are
   saved with ``torch.save`` as ``CRAFT.pth`` (keys with DataParallel's
   ``module.`` prefix) and ``CRNN.pth`` in a temporary directory;
   ``pipeline.serveModel`` builds its engines on the card from there
   (float32, the plain ``VGG_UNet`` and kernel #2 for CC, as the JAX
   engines) and answers 4 receipts through ``predict`` and
   ``get_text_detailed``; the same receipts go through the port's engines
   on the CPU, and the card must match them: mean rect IoU >= 0.99 and
   equal texts; ms per receipt on the card;
9. ``ctc_batched``: ``BatchedServeModel`` with the CTC head
   (``prediction="CTC"``, ``transform="None"``, the demo checkpoint's
   recognizer) in bf16 ``tail,s2d`` (kernels #1, #2 and #5 must launch)
   behind ``InferenceWorker``, 2 dispatches at b16; receipts/s;
10. ``http``: the HTTP front end in this process (``create_app`` behind
    ``make_server`` on 127.0.0.1, a free port, the threaded server class of
    ``run_server``), receipts sent as PNG encoded by ``data.records.encode_png``
    (stdlib ``zlib``; the card's machine has no PIL): (a) the per-image float32 ``serveModel`` of
    phase 8 behind ``create_app``'s default worker, every answer equal to
    ``predict`` on the decoded upload, kernel #2 in every request; (b) bf16
    ``tail,s2d`` ``BatchedServeModel`` behind ``InferenceWorker``, a burst of
    64 uploads from 16 client threads, each batch the worker formed replayed
    through ``predict_many`` with identical texts, kernels #1, #2 and #5 in
    every dispatch, requests/s and p50/p95 latency; (c) ``GET /``, a ``.gif``
    name, no file field and a corrupt PNG answer as the wire API says; and
    the numpy PNG decode timed on a 600x400 receipt for each row filter;
11. ``beam``: bf16 ``tail,s2d`` with the attention beam (W = 8) and with the
    CTC beam, each with a seeded LM prior (``.npy`` in a temporary
    directory): receipts/s at b16, kernels #1, #2 and #5 in every dispatch,
    the ``recognize`` stage against greedy's, and on a recorded dispatch the
    beam on the card against the beam on the CPU in float32 (top beam's
    labels equal, scores within 1e-4);
12. ``cli``: ``python -m lightly_ocr_tpu_torch.serving.server --batched
    --bf16 --decode beam --lm <prior>`` as a subprocess on 127.0.0.1 and a
    free port: ``GET /`` and one PNG upload answer, its log names ``cuda``,
    and it ends without a traceback;
13. ``train``: CRNN training at full width (``Config()``: TPS, ResNet(512),
    2xBiLSTM(256); float32, TF32 off) on word records written here (a
    seeded bitmap font, PNG without PIL, the port's ``RecordWriter``): (a)
    one forward and backward of each head at b64 from the seeded training
    init, card against CPU: the loss within 1e-4; each gradient held to the
    CPU's float64 one, within max(1e-3, 4x the CPU float32's own distance)
    relative L2; the same step in float64 on both, the loss within 1e-10
    and each gradient within 1e-8 (1e-3 in the TPS rectifier, whose grid
    is float32 in every dtype); the card fed the CPU's rectified image
    (its own within 1e-4 of it); (b) ``python -m lightly_ocr_tpu_torch.train.trainer`` as a
    subprocess (CTC head without TPS, Adam 1e-3, 200 steps at b64, words of
    3-7 digits, an eval every 20 steps, checkpoints every 100): exit 0
    without a traceback, its log
    names ``cuda``, checkpoints 100 and 200, ``best.json``, and the mean
    loss of the last 20 steps below half that of the first 20; (c) the
    step-100 checkpoint restored equal bit for bit; (d) the best
    checkpoint in ``engines.CRNN`` (strict load) reading 8 crops; (e) ms a
    train step, samples/s, peak memory, CUDA kernels a step and the top 5
    by device time, for Attention and CTC at b64 and b192, remat and
    ``grad_accum=2``; the loader's ms a batch and the numpy PNG decode of a
    word by row filter;
14. ``craft``: CRAFT detector training (``VGG_UNet``; float32, TF32 off):
    (a) one step at b2 128x96 on a ``synthesize_batch`` from the seeded
    training init, card against CPU: in float32 the loss and each gradient
    held to the CPU's float64 within max(1e-3, 4x the CPU float32's own
    distance), in float64 within 1e-10 (loss) and 1e-8 (gradients), the
    OHEM masks equal in both; and a step with ``freeze=("slice1",)`` that
    leaves slice1's parameters and moves its BatchNorm statistics; (b)
    ``python -m lightly_ocr_tpu_torch.train.trainer --model CRAFT --records``
    as a subprocess on 64 receipts of 320x256 drawn here (word rects and
    transcripts, PNG without PIL), 300 steps at b8: the loss falls and the
    held-out region IoU at 0.15 rises; (c) its checkpoint loaded strictly
    into ``engines.CRAFT`` and into ``BatchedOCR`` in bf16 ``tail,s2d``, one
    dispatch of 16 receipts at 960x640 canvases: kernels #1, #2 and #5
    launch, box counts and the mean box IoU of the two paths; (d) ms a step,
    samples/s, the device's time and kernels, the forward / OHEM / backward
    / clip + Adam split, peak memory and the float32 bound at b8 960x640 and
    b4 256x192; and the pseudo-label loader's host ms a batch.

Then one JSON line with each kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  TF32 is switched OFF for float32 matmuls
and convolutions (``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), so the plain versions
accumulate in full float32 and the float32 engines on the card can be held
to the same engines on the CPU.  Without a CUDA device the script exits 2 and
prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import io
import json
import os
import queue
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

BATCH, BOXES = 16, 32
RECEIPT_H, RECEIPT_W = 600, 400
DISPATCHES = 5  # timed dispatches of the int8 cpool2 plan
BF16_DISPATCHES = 3  # timed dispatches of the bf16 default plan
CTC_DISPATCHES = 2  # timed dispatches of the bf16 CTC plan
ENGINE_RECEIPTS = 4  # receipts through the per-image engines, card and CPU
ENGINE_IOU = 0.99  # least mean rect IoU of the card's engines against the CPU's
HTTP_BURST, HTTP_CLIENTS = 64, 16  # uploads in the batched burst, client threads
BEAM_WIDTH = 8
BEAM_DISPATCHES = 2  # timed dispatches of each beam plan
BEAM_TOL = 1e-4  # top-beam score, card vs CPU (float32, TF32 off)
CLI_DEADLINE_S = 120  # for the server subprocess to print "serving on"
SEED = 0
TRAIN_BATCH = 64  # the Config() default
TRAIN_LOSS_TOL = 1e-4  # |loss card - loss CPU| / |loss CPU|, float32, TF32 off
TRAIN_GRAD_TOL = 1e-3  # each gradient: ||card - CPU float64|| / ||CPU float64||, or up to
TRAIN_GRAD_FACTOR = 4  # this many times the CPU float32's own distance, where that is larger
TRAIN_LOSS64_TOL = 1e-10  # the same step in float64 on both: the loss,
TRAIN_GRAD64_TOL = 1e-8  # each gradient outside the TPS rectifier (rel L2),
TRAIN_GRAD64_TPS_TOL = 1e-3  # and in it (its grid is float32 in every dtype)
TRAIN_WORDS, VAL_WORDS = 256, 128  # records of the trainer CLI run
TRAIN_ALPHABET = "0123456789"  # its words' letters (the model keeps Config()'s 36 classes)
TRAIN_ITERS = 200  # steps of the trainer CLI run
TRAIN_LOG_EVERY = 20  # the CLI run's val_interval: its log's train_loss is a 20-step mean
TRAIN_SAVE_EVERY = 100  # the CLI run's save_interval
TRAIN_SPEED_STEPS = 20  # timed steps a speed case, after 3 warm-up steps
TRAIN_DEADLINE_S = 900  # for the trainer subprocess
CRAFT_PARITY_B, CRAFT_PARITY_HW = 2, (128, 96)  # phase craft (a): one step, card vs CPU
CRAFT_LOSS64_TOL = 1e-10  # float64 on both: the loss (relative),
CRAFT_GRAD64_TOL = 1e-8  # each gradient (relative L2),
CRAFT_ZERO64 = 1e-12  # a zero gradient (a conv bias before a BatchNorm): its norm over the global norm,
CRAFT_ZERO32 = 1e-5  # and in float32, or up to TRAIN_GRAD_FACTOR x the CPU float32's
CRAFT_RECEIPTS, CRAFT_HELD_OUT = 64, 8  # receipts of the detection records, and held out
CRAFT_REC_HW = (320, 256)  # their size, and the CLI run's canvas
CRAFT_STEPS, CRAFT_BATCH, CRAFT_LOG_EVERY = 300, 8, 20  # the CLI run
CRAFT_IOU_THRESH = 0.15  # eval_region_iou's threshold (tests/test_pseudo_labels.py)
CRAFT_SPEED = ((8, 960, 640), (4, 256, 192))  # (batch, height, width) of the speed cases
CRAFT_SPEED_STEPS = 10  # timed steps a speed case, after 3 warm-up steps
CRAFT_DEADLINE_S = 600  # for the CRAFT trainer subprocess
# H100 SXM data-sheet peaks (dense): bf16 and int8 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores (TF32 off)
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# seam tail kernel vs plain: both round at the same bf16 cast points, so
# most scores are bit-identical and the rest sit behind a bf16 rounding
# that fell the other way (the bounds of tests/test_torch_seam_tail.py)
TAIL_TOL = 2e-2  # max |diff|, relative to the plain scores' max |value|
TAIL_EXACT = 0.9  # least share of scores bit-identical to the plain version
TAIL_FLIPS = 1e-4  # most fg-mask pixels that flip, as a share of all pixels
# conv1_2 kernels vs plain (tests/test_torch_kernels_cuda.py's bounds):
# #4/#5/#6 sum the same bf16 operands in another order; #7's int8 sums are
# exact and it rounds as its plain version does
STEM_TOL = 1e-2  # max |diff|, relative to the plain output's max |value|
STEM_EXACT = {"stem_conv": 0.9, "conv12_pool": 0.9, "conv12_pool_conv21": 0.9,
              "conv12_pool_conv21_q": 0.99}
# #7 vs the float #6 chain: the JAX package's gate (tests/test_pallas_stem.py)
Q_CORR, Q_REL = 0.999, 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per call of ``fn`` replayed from one CUDA graph of
    ``iters`` calls: the device's time, without the host's launch work
    (which ``cuda_ms`` includes where it is the longer)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def receipts(rng: np.random.Generator, n: int) -> list:
    """Synthetic receipts: dark text-like blocks on a light ground."""
    out = []
    for _ in range(n):
        g = np.full((RECEIPT_H, RECEIPT_W), 225.0) + rng.normal(0, 4, (RECEIPT_H, RECEIPT_W))
        y = 30
        while y < RECEIPT_H - 40:
            x = int(rng.integers(20, 80))
            while x < RECEIPT_W - 60:
                w = min(int(rng.integers(20, 90)), RECEIPT_W - 20 - x)
                h = int(rng.integers(10, 18))
                g[y:y + h, x:x + w] = rng.uniform(10, 70, (h, w))
                x += w + int(rng.integers(10, 30))
            y += int(rng.integers(24, 40))
        g = np.clip(g, 0, 255)
        out.append(np.repeat(g[..., None], 3, -1).astype(np.uint8))
    return out


def tail_library(ya, t, p):
    """The seam tail as stock PyTorch bf16 calls (timing yardstick only)."""
    B, H2, W2, _ = t.shape
    tn = t.permute(0, 3, 1, 2)
    up = F.interpolate(ya.permute(0, 3, 1, 2), size=(H2, W2), mode="bilinear",
                       align_corners=False)
    x = F.relu(up + F.conv2d(tn, p.k1b.t()[:, :, None, None]).float()
               + p.b1[:, None, None]).to(torch.bfloat16)
    return chain_library(x, p)


def chain_library(x, p):
    """Kernel #3's chain (four 3x3 convs, two 1x1s) as stock PyTorch bf16
    calls on NCHW ``x`` (timing yardstick only)."""
    for wk, bk in ((p.wa, p.ba), (p.w0, p.b0), (p.w2, p.b2), (p.w4, p.b4)):
        oihw = wk.reshape(3, 3, wk.shape[1], wk.shape[2]).permute(3, 2, 0, 1)
        x = F.relu(F.conv2d(x, oihw, bk.to(torch.bfloat16), padding=1))
    x = F.relu(F.conv2d(x, p.w6.t()[:, :, None, None], p.b6.to(torch.bfloat16)))
    return F.conv2d(x, p.w8.t()[:, :, None, None], p.b8.to(torch.bfloat16))


def tail_bound_ms(B: int, H2: int, W2: int) -> tuple[float, str]:
    px = B * H2 * W2
    flops = 2 * px * (128 * 64 + 9 * 64 * 32 + 2 * 9 * 32 * 32 + 9 * 32 * 16
                      + 16 * 16 + 16 * 2)
    weights = 2 * (128 * 64 + 9 * (64 * 32 + 2 * 32 * 32 + 32 * 16) + 16 * 16 + 32)
    nbytes = px * 128 * 2 + (px // 4) * 64 * 4 + px * 2 * 4 + weights
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def chain_bound_ms(B: int, H2: int, W2: int) -> tuple[float, str]:
    """Least time for kernel #3: 41,760 MACs a map pixel (3x3 64->32,
    32->32 twice, 32->16, 1x1 16->16, 16->2) over the bf16 peak; bytes = x
    (64 bf16 channels) read once, the scores (2 f32) written once, the
    weights."""
    px = B * H2 * W2
    flops = 2 * px * (9 * 64 * 32 + 2 * 9 * 32 * 32 + 9 * 32 * 16 + 16 * 16 + 16 * 2)
    weights = 2 * (9 * (64 * 32 + 2 * 32 * 32 + 32 * 16) + 16 * 16 + 32)
    nbytes = px * 64 * 2 + px * 2 * 4 + weights
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tail_gates(name: str, got, ref):
    """The seam tail's gates on channels-second scores: max |diff| within
    TAIL_TOL of the largest, at least TAIL_EXACT bit-identical, at most
    TAIL_FLIPS of the fg-mask pixels flipped at thresholds from quantiles of
    ``ref``.  Returns (max |diff|, the fg mask of ``got``)."""
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    region, link = ref[:, :, 0], ref[:, :, 1]
    low_text = torch.quantile(region.flatten()[:: 97].float(), 0.80).item()
    link_thr = torch.quantile(link.flatten()[:: 97].float(), 0.97).item()
    fg_ref = (region > low_text) | (link > link_thr)
    fg_got = (got[:, :, 0] > low_text) | (got[:, :, 1] > link_thr)
    flips = int((fg_ref != fg_got).sum().item())
    exact = (got == ref).float().mean().item()
    log(f"{name}: maxdiff {err:.3e} (max |score| {scale:.3e}, tol {TAIL_TOL} x max); "
        f"bit-identical {exact:.4f} (min {TAIL_EXACT}); fg flips {flips} of {fg_ref.numel()} "
        f"(max {TAIL_FLIPS} x) at low_text {low_text:.4g} link {link_thr:.4g}")
    assert err <= TAIL_TOL * max(scale, 1e-6), f"{name} kernel disagrees with its plain version"
    assert exact >= TAIL_EXACT, f"{name} kernel: too few scores equal the plain version"
    assert flips <= TAIL_FLIPS * fg_ref.numel(), f"{name} kernel: too many fg-mask flips"
    return err, fg_got


def stem_library(x0, w1, b1, w2=None, b2=None):
    """conv1_2 + pool (+ conv2_1) as stock PyTorch bf16 calls with the folded
    weights: ``conv2d``, ReLU, ``max_pool2d`` (timing yardstick only)."""
    y = F.max_pool2d(F.relu(F.conv2d(x0.permute(0, 3, 1, 2), w1, b1, padding=1)), 2)
    if w2 is not None:
        y = F.relu(F.conv2d(y, w2, b2, padding=1))
    return y


def stem_bound_ms(B: int, H: int, W: int, conv21: bool, int8: bool,
                  pool: bool = True) -> tuple[float, str]:
    """Least time for kernel #5 (``conv21`` False), #6/#7, or #4 (``pool``
    False): the 3x3 64->64 conv at full resolution (+ the 3x3 64->128 conv
    at half) over the bf16 or int8 peak; bytes = x0 (bf16) read once, the
    weights, the bf16 output (pooled, or full-resolution for #4) written
    once."""
    px = B * H * W
    flops = 2 * px * 576 * 64 + (2 * (px // 4) * 576 * 128 if conv21 else 0)
    wbytes = (1 if int8 else 2) * 576 * (64 + (128 if conv21 else 0))
    out_px = px // 4 if pool else px
    nbytes = px * 64 * 2 + out_px * (128 if conv21 else 64) * 2 + wbytes
    t_ops = flops / (PEAK_INT8_OPS if int8 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def stem_phase(ocr, canv) -> dict:
    """Kernels #4-#7 vs their plain versions on the served model's conv1_1
    activation of ``canv``; returns {name: partial kernels-line entry}."""
    from lightly_ocr_tpu_torch.ops import stem

    p = ocr.stem
    with torch.inference_mode():
        x0 = ocr.det_net.stem_prefix(canv).contiguous()
    B, H, W, _ = x0.shape
    assert stem.conv_pool_supported(H, W), (H, W)
    w1 = stem._oihw(p.w1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w2 = stem._oihw(p.w2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b1, b2 = p.b1.to(torch.bfloat16), p.b2.to(torch.bfloat16)
    lib = {"stem_conv": lambda: F.relu(F.conv2d(x0.permute(0, 3, 1, 2), w1, b1, padding=1)),
           "conv12_pool": lambda: stem_library(x0, w1, b1),
           "conv12_pool_conv21": lambda: stem_library(x0, w1, b1, w2, b2)}
    lib["conv12_pool_conv21_q"] = lib["conv12_pool_conv21"]
    out = {}
    for name, line_no in (("stem_conv", 46), ("conv12_pool", 255), ("conv12_pool_conv21", 430),
                          ("conv12_pool_conv21_q", 597)):
        fn = getattr(stem, "fused_" + name)
        plain = getattr(stem, "fused_stem_conv_plain" if name == "stem_conv" else name + "_plain")
        with torch.inference_mode():
            got = fn(x0, p)
            torch.cuda.synchronize()
            ref = plain(x0, p)
            torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.isfinite(got.float()).all(), name
        gf, rf = got.float(), ref.float()
        err = (gf - rf).abs().max().item()
        scale = rf.abs().max().item()
        exact = (gf == rf).float().mean().item()
        log(f"{name}: {tuple(got.shape)} maxdiff {err:.3e} (max |out| {scale:.3e}, tol {STEM_TOL} x max); "
            f"bit-identical {exact:.5f} (min {STEM_EXACT[name]})")
        assert err <= STEM_TOL * max(scale, 1e-6), f"{name} kernel disagrees with its plain version"
        assert exact >= STEM_EXACT[name], f"{name} kernel: too few outputs equal the plain version"
        if name.endswith("_q"):
            with torch.inference_mode():
                fl = stem.conv12_pool_conv21_plain(x0, p).float()
            corr = torch.corrcoef(torch.stack([fl.flatten().double(), gf.flatten().double()]))[0, 1].item()
            rel = (fl - gf).abs().max().item() / max(fl.abs().max().item(), 1e-9)
            log(f"{name} vs float #6 chain: corr {corr:.6f} (min {Q_CORR}), rel maxdiff {rel:.4f} (max {Q_REL})")
            assert corr > Q_CORR and rel < Q_REL, "int8 kernel too far from the float chain"
        del got, ref, gf, rf
        with torch.inference_mode():
            ms = cuda_ms(lambda: fn(x0, p), iters=10)
            plain_ms = cuda_ms(lambda: plain(x0, p), iters=3)
            lib_ms = cuda_ms(lib[name], iters=10)
        bound, by = stem_bound_ms(B, H, W, name.startswith("conv12_pool_conv21"),
                                  name.endswith("_q"), pool=name != "stem_conv")
        q = name.endswith("_q")  # PyTorch has no int8 conv: the bf16 chain is shown for scale only
        log(f"{name} ms: kernel {ms:.3f} plain {plain_ms:.3f} "
            f"{'bf16 chain for scale (not the same function)' if q else 'library (cuDNN bf16 chain)'} "
            f"{lib_ms:.3f} bound {bound:.3f} ({by})")
        out[name] = {"name": name, "route": "cuda",
                     "source": "lightly_ocr_tpu_torch/csrc/stem.cu",
                     "replaces": f"lightly_ocr_tpu/ops/pallas_stem.py:{line_no}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": None if q else lib_ms}
    # #7's launches one by one, each on what the ones before it wrote: the
    # split of its time
    with torch.inference_mode():
        _, launches = stem.int8_launches(x0, p)
        split = {name: cuda_ms(launch, iters=10) for name, launch in launches}
    log("conv12_pool_conv21_q launches ms: "
        + ", ".join(f"{name} {t:.3f}" for name, t in split.items()) + f" (sum {sum(split.values()):.3f})")
    return out


def launch_counts() -> dict:
    from lightly_ocr_tpu_torch.ops import cc, seam_tail, stem

    return {"seam_tail": seam_tail.seam_tail.launches, "cc": cc.label_components.launches,
            "tail": seam_tail.tail_scores.launches,
            "stem_conv": stem.fused_stem_conv.launches,
            "conv12_pool": stem.fused_conv12_pool.launches,
            "conv12_pool_conv21": stem.fused_conv12_pool_conv21.launches,
            "conv12_pool_conv21_q": stem.fused_conv12_pool_conv21_q.launches}


def reset_launch_counts() -> None:
    from lightly_ocr_tpu_torch.ops import cc, seam_tail, stem

    seam_tail.seam_tail.launches = 0
    seam_tail.tail_scores.launches = 0
    cc.label_components.launches = 0
    for fn in (stem.fused_stem_conv, stem.fused_conv12_pool, stem.fused_conv12_pool_conv21,
               stem.fused_conv12_pool_conv21_q):
        fn.launches = 0


def serve(cfg, det_sd, rec_sd, imgs, dispatches: int, label: str):
    """Receipts through ``InferenceWorker`` + ``BatchedServeModel``: one warm
    round, then ``dispatches`` timed batches.  Returns (model, launch
    counts of the timed run, receipts/s, answers)."""
    from lightly_ocr_tpu_torch.serving.server import BatchedServeModel, InferenceWorker

    model = BatchedServeModel(cfg, thresh=-1.0, boxes_per_image=BOXES, device="cuda",
                              det_state=det_sd, rec_state=rec_sd)
    worker = InferenceWorker(model.predict_many, max_batch=BATCH, max_queue=0)
    try:
        [f.result(timeout=600) for f in [worker.submit(im) for im in imgs]]
        torch.cuda.synchronize()
        reset_launch_counts()
        tw = time.perf_counter()
        futs = [worker.submit(im) for _ in range(dispatches) for im in imgs]
        answers = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - tw
        launches = launch_counts()
    finally:
        worker.close()
    assert not worker.thread.is_alive(), "worker thread did not stop"
    rps = len(answers) / wall
    log(f"e2e {label}: {len(answers)} receipts in {wall:.3f} s = {rps:.2f} receipts/s "
        f"(batch {BATCH}, {dispatches} dispatches); launches {launches}")
    n_boxes = [len(a) for a in answers]
    log(f"e2e {label} boxes per receipt: min {min(n_boxes)} max {max(n_boxes)}; sample {answers[0][:4]}")
    assert max(n_boxes) > 0, f"{label}: no receipt got a box"
    out = model.ocr.run_images(imgs[:2])
    for items in out:
        for it in items:
            r0, c0, r1, c1 = it["rect"]
            assert 0 <= r0 < r1 <= RECEIPT_H and 0 <= c0 < c1 <= RECEIPT_W, it
            assert 0.0 <= it["confidence"] <= 1.0 and np.isfinite(it["confidence"]), it
    return model, launches, rps, answers


def plan_dispatches(cfg, det_sd, rec_sd, args) -> dict:
    """One dispatch of each other serving plan on the prepared batch
    ``args``, against the bf16 default plan; returns {plan: launches}."""
    import os

    from lightly_ocr_tpu_torch.models.layers import QuantConv
    from lightly_ocr_tpu_torch.serving.batch import BatchedOCR

    def run(c, seamk=None):
        if seamk is None:
            return dispatch(c)
        old = os.environ.get("LIGHTLY_OCR_TAIL_SEAMK")
        os.environ["LIGHTLY_OCR_TAIL_SEAMK"] = seamk
        try:
            return dispatch(c)
        finally:
            if old is None:
                del os.environ["LIGHTLY_OCR_TAIL_SEAMK"]
            else:
                os.environ["LIGHTLY_OCR_TAIL_SEAMK"] = old

    def dispatch(c):
        ocr = BatchedOCR(c, det_sd, rec_sd, boxes_per_image=BOXES, device="cuda")
        int8 = [0]
        hooks = [m.register_forward_hook(lambda *a: int8.__setitem__(0, int8[0] + 1))
                 for m in ocr.det_net.modules() if isinstance(m, QuantConv) and m.quantized]
        with torch.inference_mode():
            ocr(*args)  # warm
            torch.cuda.synchronize()
            reset_launch_counts()
            int8[0] = 0
            tm, lm = ocr.detector_scores(args[0])
            res = ocr.postprocess(tm, lm, *args[1:])
            torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        return torch.stack([tm, lm]), res, {**launch_counts(), "int8_convs": int8[0]}

    ref_s, ref, ref_launches = run(cfg)
    assert ref_launches["seam_tail"] > 0 and ref_launches["tail"] == 0, ref_launches
    plans = {"bf16 tail,cpool": (cfg.replace(fused_stages="tail,cpool"), None, ("conv12_pool",)),
             "bf16 tail,cpool2": (cfg.replace(fused_stages="tail,cpool2"), None, ("conv12_pool_conv21",)),
             "int8 tail,s2d": (cfg.replace(quant_int8=True), None, ("int8_convs",)),
             "bf16 tail,stem": (cfg.replace(fused_stages="tail,stem"), None,
                                ("stem_conv", "seam_tail", "cc")),
             "bf16 tail,s2d SEAMK=0": (cfg, "0", ("tail", "cc"))}
    out = {}
    for label, (c, seamk, needs) in plans.items():
        sc, res, launches = run(c, seamk)
        rel = ((sc - ref_s).abs().max() / ref_s.abs().max()).item()
        va, vb = ref["valid"], res["valid"]
        same = va & vb & ((ref["rects"] - res["rects"]).abs().amax(-1) <= 1.0)
        share = same.sum().item() / max(1, (va | vb).sum().item())
        log(f"plan {label}: launches {launches}; vs bf16 tail,s2d: score maxdiff {rel:.4f} of max |score|, "
            f"matching boxes {share:.4f} ({int(va.sum())} vs {int(vb.sum())} valid)")
        for k in needs:
            assert launches[k] > 0, f"plan {label}: {k} did not run"
        if seamk == "0":
            # kernel #3 in place of the seam kernel: the same function, so
            # the default plan's maps hold it by the seam tail's gates
            # (bit-identity aside: the front's sums run in another order)
            assert launches["seam_tail"] == 0, f"plan {label}: the seam kernel ran"
            cs = lambda m: torch.stack([m[0], m[1]], 2)  # noqa: E731  [B, H2, 2, W2]
            got, want = cs(sc), cs(ref_s)
            low = torch.quantile(want[:, :, 0].flatten()[:: 97], 0.80).item()
            link = torch.quantile(want[:, :, 1].flatten()[:: 97], 0.97).item()
            flips = int((((got[:, :, 0] > low) | (got[:, :, 1] > link))
                         != ((want[:, :, 0] > low) | (want[:, :, 1] > link))).sum().item())
            log(f"plan {label}: fg flips {flips} of {want[:, :, 0].numel()} (max {TAIL_FLIPS} x)")
            assert rel <= TAIL_TOL, f"plan {label}: scores too far from the seam path"
            assert flips <= TAIL_FLIPS * want[:, :, 0].numel(), f"plan {label}: too many fg flips"
        out[label] = launches
    return out


def rect_iou(a, b) -> float:
    r0, c0 = max(a[0], b[0]), max(a[1], b[1])
    r1, c1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0, r1 - r0) * max(0, c1 - c0)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(union, 1e-9)


def engines_phase(cfg, det_sd, rec_sd, imgs, smi: str):
    """The per-image engines from ``.pth`` files on the card against the
    same engines on the CPU; returns the card's ``serveModel``."""
    import os
    import shutil
    import tempfile

    from lightly_ocr_tpu_torch import pipeline

    tmp = tempfile.mkdtemp(prefix="lightly_ocr_pth_")
    try:
        torch.save({"module." + k: v for k, v in det_sd.items()}, os.path.join(tmp, "CRAFT.pth"))
        torch.save(rec_sd, os.path.join(tmp, "CRNN.pth"))
        e_cfg = cfg.replace(pretrained=tmp)
        model = pipeline.serveModel(config=e_cfg, thresh=-1.0, device="cuda")
        cpu = pipeline.prepModel(e_cfg, device="cpu")
    finally:
        shutil.rmtree(tmp)
    receipts = imgs[:ENGINE_RECEIPTS]
    det, rec = model.detector, model.recognizer

    def per_receipt(fn, args):
        """(results, ms per receipt on the host clock between synchronises)"""
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = [fn(*a) for a in args]
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t) / len(args)

    pipeline.get_text_detailed(receipts[0], det, rec)  # warm
    reset_launch_counts()
    card, ms = per_receipt(lambda im: pipeline.get_text_detailed(im, det, rec), [(im,) for im in receipts])
    launches = launch_counts()
    rects, det_ms = per_receipt(det.detect_rects, [(im,) for im in receipts])
    grays = [pipeline.gray_from_rgb(im) for im in receipts]
    _, rec_ms = per_receipt(rec.process_batch, list(zip(grays, rects)))
    predicted = [model.predict(im) for im in receipts]
    host = [pipeline.get_text_detailed(im, *cpu) for im in receipts]
    ious, same_text, n = [], 0, 0
    for got, want, pred in zip(card, host, predicted):
        assert len(got) == len(want), f"engines: {len(got)} boxes on the card, {len(want)} on the CPU"
        # predict reads getText's {confidence: text}, where equal confidences collapse
        assert pred == list({it["confidence"]: it["text"] for it in got}.values()), \
            "engines: predict disagrees with get_text_detailed"
        ious += [rect_iou(g["rect"], w["rect"]) for g, w in zip(got, want)]
        same_text += sum(g["text"] == w["text"] for g, w in zip(got, want))
        n += len(got)
    iou = float(np.mean(ious)) if ious else 0.0
    log(f"engines: {len(receipts)} receipts, {n} boxes; card vs CPU: mean rect IoU {iou:.6f} "
        f"(min {ENGINE_IOU}), texts equal {same_text}/{n}; sample {card[0][:3]}")
    log(f"engines ms per receipt (card, float32): get_text_detailed {ms:.2f} "
        f"(CRAFT.detect_rects {det_ms:.2f}, CRNN.process_batch {rec_ms:.2f}) on {smi}; "
        f"launches {launches}")
    assert n > 0, "engines: no box on any receipt"
    assert iou >= ENGINE_IOU, "engines: the card's rects differ from the CPU's"
    assert same_text == n, "engines: the card's texts differ from the CPU's"
    assert launches["cc"] == len(receipts), f"engines: CC kernel not in every detect: {launches}"
    return model


def module_ms(net, names, fn, iters: int = 3) -> dict:
    """Milliseconds per call of ``fn`` spent inside each named submodule
    of ``net``, from CUDA events recorded by forward hooks."""
    spans = {n: [] for n in names}
    hooks = []
    for n in names:
        m = getattr(net, n)

        def pre(mod, args, n=n):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[n].append([ev, None])

        def post(mod, args, res, n=n):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[n][-1][1] = ev

        hooks += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    try:
        fn()
        torch.cuda.synchronize()
        for n in names:
            spans[n].clear()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return {n: sum(a.elapsed_time(b) for a, b in spans[n]) / iters for n in names}


def stage_times(ocr, imgs) -> dict:
    """Milliseconds of each stage of one ``run_images`` dispatch, timed
    through ``BatchedOCR``'s own methods (CUDA events for device stages,
    the host clock around synchronised host stages), each run on the
    previous stage's real output.  ``cc`` and the recognizer's parts are
    also shown inside ``boxes`` and ``recognize``."""
    from lightly_ocr_tpu_torch.ops.cc import label_components
    from lightly_ocr_tpu_torch.ops.seam_tail import fused_tail_scores_cs_seam

    cfg, out = ocr.cfg, {}

    def host_ms(fn, iters=3):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            r = fn()
        torch.cuda.synchronize()
        return r, 1e3 * (time.perf_counter() - t) / iters

    with torch.inference_mode():
        _, out["run_images_total"] = host_ms(lambda: ocr.run_images(imgs))
        groups = ocr.group(imgs)
        assert len(groups) == 1, groups
        (cb, gb), idxs = next(iter(groups.items()))
        group = [imgs[i] for i in idxs]
        (canv, gray, inv, ext), out["host_prep"] = host_ms(lambda: ocr.prepare(group, cb, gb))
        if ocr.front is not None:  # conv1_1 prefix, fused kernel, resumed trunk
            out["stem_prefix"] = cuda_ms(lambda: ocr.prefix(canv), iters=3)
            x0 = ocr.prefix(canv)
            out[ocr.front.__name__] = cuda_ms(lambda: ocr.front(x0, ocr.stem), iters=3)
            p1 = ocr.front(x0, ocr.stem)
            del x0
            y_lo, t = ocr.det_net.trunk(p1, resume=ocr.resume)
            out["detector_trunk"] = cuda_ms(lambda: ocr.det_net.trunk(p1, resume=ocr.resume), iters=3)
            del p1
        else:
            y_lo, t = ocr.det_net.trunk(canv)
            out["detector_trunk"] = cuda_ms(lambda: ocr.det_net.trunk(canv), iters=3)
        out["seam_tail_with_ya"] = cuda_ms(lambda: fused_tail_scores_cs_seam(ocr.tail, y_lo, t), iters=3)
        tm, lm = ocr.detector_scores(canv)
        fg = ((tm > cfg.low_text) | (lm > cfg.link_threshold)).contiguous()
        out["cc"] = cuda_ms(lambda: label_components(fg), iters=3)
        out["boxes"] = cuda_ms(lambda: ocr.boxes(tm, lm, inv, ext), iters=3)
        rects, _ = ocr.boxes(tm, lm, inv, ext)
        out["recognize"] = cuda_ms(lambda: ocr.recognize(gray, rects), iters=3)
        out["crop"] = cuda_ms(lambda: ocr.crops(gray, rects), iters=3)
        crops = ocr.crops(gray, rects)
        out.update(module_ms(ocr.rec_net, ("Transformation", "FeatureExtraction",
                                           "SequenceModeling", "Prediction"),
                             lambda: ocr.rec_net(crops)))
        res = ocr.postprocess(tm, lm, gray, inv, ext)
        _, out["host_decode"] = host_ms(lambda: ocr.decode(res))
    return out


def multipart(filename: str, content: bytes, field: str = "file") -> tuple[bytes, str]:
    boundary = "chipsmoke7c1f"
    head = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{field}\"; "
            f"filename=\"{filename}\"\r\nContent-Type: application/octet-stream\r\n\r\n").encode()
    return head + content + f"\r\n--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def http_call(url: str, body: bytes | None = None, ctype: str | None = None,
              timeout: float = 300.0) -> tuple[int, dict, float]:
    """One request -> (HTTP status, JSON payload, seconds on the host clock)."""
    req = urllib.request.Request(url, data=body, method="GET" if body is None else "POST",
                                 headers={"Content-Type": ctype} if ctype else {})
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:  # 4xx/5xx still carry the JSON body
        status, raw = e.code, e.read()
    return status, json.loads(raw), time.perf_counter() - t


@contextlib.contextmanager
def served(app):
    """``app`` behind ``make_server`` on 127.0.0.1 and a free port, with the
    threaded server class of ``run_server``; yields the base URL, then
    stops the server and the app's worker."""
    from wsgiref.simple_server import WSGIRequestHandler, make_server

    from lightly_ocr_tpu_torch.serving.server import ThreadingWSGIServer

    class Quiet(WSGIRequestHandler):
        def log_message(self, *args):  # one line a request would flood stderr
            pass

    httpd = make_server("127.0.0.1", 0, app, server_class=ThreadingWSGIServer, handler_class=Quiet)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_port}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        app.worker.close()
    assert not thread.is_alive() and not app.worker.thread.is_alive(), "server threads did not stop"


def http_phase(cfg, det_sd, rec_sd, imgs, engine_model, smi: str) -> dict:
    """Phase ``http``: (a) the per-image model behind ``create_app``'s
    default worker, (b) a burst into the batched model, (c) the error
    paths, and the front end's host costs.  Returns numbers for the log."""
    from lightly_ocr_tpu_torch.data.records import encode_png
    from lightly_ocr_tpu_torch.serving import server
    from lightly_ocr_tpu_torch.serving.upload import decode_png, decode_upload

    tmp = tempfile.mkdtemp(prefix="lightly_ocr_http_")
    pngs = [encode_png(im) for im in imgs]
    out = {}
    try:
        # the front end's host work per upload: multipart parse, PNG decode by filter
        body, ctype = multipart("r.png", pngs[0])
        env = {"CONTENT_TYPE": ctype, "CONTENT_LENGTH": str(len(body))}
        t = time.perf_counter()
        for _ in range(10):
            server._parse_multipart({**env, "wsgi.input": io.BytesIO(body)})
        out["multipart_ms"] = 1e3 * (time.perf_counter() - t) / 10
        decode_ms = {}
        for filt, name in enumerate(("none", "sub", "up", "average", "paeth")):
            data = encode_png(imgs[0], filt)
            t = time.perf_counter()
            got = decode_png(data)
            decode_ms[name] = 1e3 * (time.perf_counter() - t)
            assert np.array_equal(got, imgs[0]), f"png decode ({name}) differs from the receipt"
        out["decode_ms"] = decode_ms
        log(f"http front end on the host (600x400 RGB receipt, {len(body)} bytes as Up-filtered PNG): "
            f"multipart parse {out['multipart_ms']:.3f} ms; numpy PNG decode ms by row filter "
            + ", ".join(f"{k} {v:.2f}" for k, v in decode_ms.items()) + f" (host of {smi})")

        # (a) per-image float32 engines behind the default worker
        app = server.create_app(engine_model, upload_folder=tmp)
        with served(app) as base:
            torch.cuda.synchronize()
            reset_launch_counts()
            answers = [http_call(base + "/api", *multipart(f"r{i}.png", pngs[i]))
                       for i in range(ENGINE_RECEIPTS)]
            a_launches = launch_counts()
        n_texts = 0
        for i, (status, payload, _) in enumerate(answers):
            assert status == 200 and payload["status"] == "OK", (status, payload)
            decoded = decode_upload(pngs[i])
            assert np.array_equal(decoded, imgs[i]), "the upload did not decode to the receipt"
            want = engine_model.predict(decoded)
            assert payload["results"] == {str(k): t for k, t in enumerate(want)}, \
                f"http (a): request {i} answered otherwise than predict"
            n_texts += len(want)
        assert n_texts > 0, "http (a): no text in any answer"
        assert a_launches["cc"] == ENGINE_RECEIPTS, f"http (a): CC not in every request: {a_launches}"
        ms_a = [1e3 * a[2] for a in answers]
        log(f"http (a) per-image float32 serveModel: {ENGINE_RECEIPTS} uploads answered as predict "
            f"({n_texts} texts); ms per request {np.mean(ms_a):.2f} (first {ms_a[0]:.2f}); "
            f"launches {a_launches} on {smi}")

        # (b) a burst into the batched bf16 model; the worker's batches recorded
        model = server.BatchedServeModel(cfg, thresh=-1.0, boxes_per_image=BOXES, device="cuda",
                                         det_state=det_sd, rec_state=rec_sd)
        # warm every batch shape the worker can form (BatchedOCR pads to a
        # power of two); the first call of a shape is the cold cost
        cold_ms = {}
        b = 1
        while b <= BATCH:
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.predict_many(imgs[:b])
            torch.cuda.synchronize()
            cold_ms[b] = round(1e3 * (time.perf_counter() - t), 1)
            b *= 2
        log(f"http (b) first call of each batch shape, ms: {cold_ms} on {smi}")
        batches = []

        def recorded(images):
            texts = model.predict_many(images)
            batches.append((list(images), texts))
            return texts

        app = server.create_app(model, upload_folder=tmp, worker=server.InferenceWorker(recorded))
        with served(app) as base:
            torch.cuda.synchronize()
            reset_launch_counts()
            results = [None] * HTTP_BURST

            def client(k):
                for j in range(k, HTTP_BURST, HTTP_CLIENTS):
                    results[j] = http_call(base + "/api", *multipart(f"b{j}.png", pngs[j % len(pngs)]))

            threads = [threading.Thread(target=client, args=(k,)) for k in range(HTTP_CLIENTS)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            wall = time.perf_counter() - t
            assert not any(th.is_alive() for th in threads), "http (b): a client hung"
            b_launches = launch_counts()
            # (c) the wire API's other answers, on the card's server
            checks = {"GET /": (http_call(base + "/"), 200, {"status": "online"}),
                      "gif": (http_call(base + "/api", *multipart("anim.gif", b"GIF89a")), 404,
                              {"status": "badInput"}),
                      "no file field": (http_call(base + "/api", *multipart("r.png", pngs[0], "other")),
                                        403, {"status": "noInput"}),
                      "corrupt png": (http_call(base + "/api", *multipart("r.png", pngs[0][:5000])), 404,
                                      {"status": "badInput"})}
        for name, ((status, payload, _), want_status, want) in checks.items():
            assert status == want_status and payload == want, f"http (c) {name}: {status} {payload}"
        statuses = [r[0] for r in results]
        assert statuses == [200] * HTTP_BURST, f"http (b): statuses {statuses}"
        sizes = [len(b[0]) for b in batches]
        assert sum(sizes) == HTTP_BURST, sizes
        for k in ("seam_tail", "conv12_pool", "cc"):
            assert b_launches[k] == len(batches), f"http (b): {k} not in every dispatch: {b_launches}"
        # every answer is one the worker's batches gave, and each batch replays identically
        answered = sorted(tuple(r[1]["results"].values()) for r in results)
        assert answered == sorted(tuple(t) for _, texts in batches for t in texts), \
            "http (b): the answers are not the worker's batch outputs"
        for images, texts in batches:
            assert model.predict_many(images) == texts, "http (b): a batch replayed differently"
        lat = np.array([1e3 * r[2] for r in results])
        out.update(rps=HTTP_BURST / wall, p50=float(np.percentile(lat, 50)),
                   p95=float(np.percentile(lat, 95)), sizes=sizes)
        log(f"http (b) bf16 tail,s2d batched: {HTTP_BURST} uploads from {HTTP_CLIENTS} client threads "
            f"in {wall:.3f} s = {out['rps']:.2f} requests/s; latency p50 {out['p50']:.1f} ms "
            f"p95 {out['p95']:.1f} ms max {lat.max():.1f} ms; batches the worker formed {sizes}; "
            f"each replayed identically; launches {b_launches} on {smi}")
        log("http (c): GET / online, .gif 404 badInput, no file field 403 noInput, "
            "corrupt PNG 404 badInput")
        del model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def beam_phase(cfg, det_sd, rec_sd, c_rec_sd, imgs, prior_path: str, greedy_rps: dict,
               smi: str) -> None:
    """Phase ``beam``: the attention and the CTC beam (W = ``BEAM_WIDTH``)
    with the LM prior at ``prior_path``, served in bf16 ``tail,s2d``."""
    from lightly_ocr_tpu_torch.ops.ctc import ctc_beam_search_decode
    from lightly_ocr_tpu_torch.serving.batch import BatchedOCR

    heads = {"attention": (cfg.replace(attn_decode="beam", beam_width=BEAM_WIDTH,
                                       ctc_lm_path=prior_path), rec_sd),
             "ctc": (cfg.replace(prediction="CTC", transform="None", ctc_decode="beam",
                                 beam_width=BEAM_WIDTH, ctc_lm_path=prior_path), c_rec_sd)}
    for name, (b_cfg, r_sd) in heads.items():
        label = f"bf16 tail,s2d {name} beam W={BEAM_WIDTH} + LM"
        model, launches, rps, answers = serve(b_cfg, det_sd, r_sd, imgs, BEAM_DISPATCHES, label)
        for k in ("conv12_pool", "seam_tail", "cc"):
            assert launches[k] == BEAM_DISPATCHES, f"beam {name}: {k} not in every dispatch: {launches}"
        ocr = model.ocr
        assert ocr.lm is not None and all(isinstance(t, str) for a in answers for t in a)
        greedy = BatchedOCR(b_cfg.replace(attn_decode="greedy", ctc_decode="greedy", ctc_lm_path=""),
                            det_sd, r_sd, boxes_per_image=BOXES, device="cuda")
        feats = {}
        hook = ocr.rec_net.Prediction.register_forward_pre_hook(
            lambda mod, args: feats.__setitem__("x", args[0]))
        with torch.inference_mode():
            (cb, gb), idxs = next(iter(ocr.group(imgs).items()))
            canv, gray, inv, ext = ocr.prepare([imgs[i] for i in idxs], cb, gb)
            tm, lm = ocr.detector_scores(canv)
            rects, _ = ocr.boxes(tm, lm, inv, ext)
            beam_ms = cuda_ms(lambda: ocr.recognize(gray, rects), iters=3)
            greedy_ms = cuda_ms(lambda: greedy.recognize(gray, rects), iters=3)
            x = ocr.rec_net(ocr.crops(gray, rects))  # CTC: the logits; attention: the hook keeps its input
            hook.remove()
            if name == "ctc":
                x = x.float()

                def beam(x, lm):
                    labels, _, scores = ctc_beam_search_decode(x, BEAM_WIDTH, lm=lm)
                    return labels[:, 0], scores[:, 0]
            else:
                x = feats["x"].float()
                nets = {d: copy.deepcopy(ocr.rec_net.Prediction).float().to(d) for d in ("cuda", "cpu")}

                def beam(x, lm):
                    tokens, scores = nets[x.device.type](x, BEAM_WIDTH, lm)
                    return tokens[:, 0], scores[:, 0]
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            with prof:
                card = beam(x, ocr.lm)
                torch.cuda.synchronize()
            kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
            n_kernels = sum(e.count for e in kern)
            top = sorted(kern, key=lambda e: e.device_time_total, reverse=True)[:5]
            beam_only_ms = cuda_ms(lambda: beam(x, ocr.lm), iters=3)
            host = beam(x.cpu(), ocr.lm.cpu())
        same = (card[0].cpu() == host[0]).all(-1)
        err = (card[1].cpu() - host[1]).abs().max().item()
        log(f"beam {name}: {rps:.2f} receipts/s at b{BATCH} ({greedy_rps[name]:.2f} greedy); "
            f"recognize ms, {x.shape[0]} crops: beam + LM {beam_ms:.3f}, greedy {greedy_ms:.3f}; "
            f"the beam alone on its {'logits' if name == 'ctc' else 'sequence features'} "
            f"{beam_only_ms:.3f} ms, {n_kernels} CUDA kernels (torch.profiler); on {smi}")
        log(f"beam {name} kernels by device time (torch.profiler, one call): "
            + "; ".join(f"{e.key[:60]} x{e.count} {e.device_time_total / 1e3:.3f} ms" for e in top)
            + f" on {smi}")
        log(f"beam {name} card vs CPU (float32, TF32 off): top beam labels equal "
            f"{int(same.sum())}/{same.numel()}, max |score diff| {err:.3e} (tol {BEAM_TOL}); "
            f"on {smi}; sample {answers[0][:4]}")
        assert bool(same.all()), f"beam {name}: the card's top beams differ from the CPU's"
        assert err <= BEAM_TOL, f"beam {name}: the card's scores differ from the CPU's"
        del model, greedy


def cli_phase(prior_path: str, png: bytes, smi: str) -> None:
    """Phase ``cli``: the server's entry point as users start it."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="lightly_ocr_cli_")  # its upload folder and log
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
    cmd = [sys.executable, "-m", "lightly_ocr_tpu_torch.serving.server", "--batched", "--bf16",
           "--decode", "beam", "--lm", prior_path, "--host", "127.0.0.1", "--port", str(port)]
    err_path = os.path.join(work, "stderr.log")
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=work, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        lines: queue.Queue = queue.Queue()
        threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
        ready = None
        while ready is None and time.perf_counter() - t0 < CLI_DEADLINE_S:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                assert proc.poll() is None, f"cli: the server exited with {proc.returncode}"
                continue
            if line.startswith("serving on"):
                ready = line.strip()
        assert ready == f"serving on 127.0.0.1:{port}", f"cli: no 'serving on' line ({ready})"
        start_s = time.perf_counter() - t0
        status, payload, get_s = http_call(f"http://127.0.0.1:{port}/")
        assert status == 200 and payload == {"status": "online"}, (status, payload)
        status, payload, post_s = http_call(f"http://127.0.0.1:{port}/api", *multipart("r.png", png))
        assert status == 200 and payload["status"] == "OK" and isinstance(payload["results"], dict), \
            (status, payload)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    with open(err_path) as f:
        stderr = f.read()
    shutil.rmtree(work, ignore_errors=True)
    plan = [ln for ln in stderr.splitlines() if "device cuda" in ln]
    log(f"cli: {' '.join(cmd[1:4])} ... ready in {start_s:.2f} s; GET / {1e3 * get_s:.1f} ms; "
        f"first PNG upload {1e3 * post_s:.1f} ms, {len(payload['results'])} texts, on {smi}; log: {plan}")
    assert "Traceback" not in stderr, "cli: traceback in the server's stderr:\n" + stderr[-4000:]
    assert plan, "cli: the server's log does not name the cuda device:\n" + stderr[-4000:]


def glyph_font(charset: str, seed: int) -> dict:
    """A seeded bitmap "font": one random 20x9 binary glyph a character, a
    5x3 grid of 4x3-pixel blocks (coarse enough to survive the ResNet's
    pooling)."""
    rng = np.random.default_rng(seed)
    return {c: np.kron(rng.random((5, 3)) < 0.5, np.ones((4, 3), bool)) for c in charset}


def word_image(text: str, font: dict, rng: np.random.Generator) -> np.ndarray:
    """``text`` drawn with ``font`` as uint8 gray [32, 11 * len + 6]: dark
    glyphs on a light noisy ground, so the image depends on the label."""
    img = np.full((32, 11 * len(text) + 6), float(rng.integers(190, 240)))
    ink = float(rng.integers(10, 70))
    for i, c in enumerate(text):
        img[6:26, 3 + 11 * i: 12 + 11 * i][font[c]] = ink
    img += rng.normal(0.0, 6.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def word_records(path: str, n: int, font: dict, charset: str, seed: int) -> list:
    """``n`` seeded words of 3-7 characters written as PNG records with the
    port's ``RecordWriter``; returns the labels."""
    from lightly_ocr_tpu_torch.data.records import RecordWriter, encode_png

    rng = np.random.default_rng(seed)
    labels = []
    with RecordWriter(path) as w:
        for _ in range(n):
            text = "".join(rng.choice(list(charset), size=int(rng.integers(3, 8))))
            w.add(text, encode_png(word_image(text, font, rng)))
            labels.append(text)
    return labels


def train_grads(cfg, images: np.ndarray, labels: list, dev: str) -> dict:
    """One forward and backward of the model from the seeded training init,
    on the CPU in float64 (the reference) and float32, and on the card in
    float32 and float64: ``{run: (loss, {name: gradient}, seconds)}``, and
    under ``"rect"`` each run's rectified image.  The card is fed the CPU's
    rectified image of its dtype (straight through: the gradient still
    flows through the card's own TPS): the grids of the two TPS round
    differently, and the gradients move by more than the gate for such a
    change of the input."""
    from lightly_ocr_tpu_torch.text.converters import build_converter
    from lightly_ocr_tpu_torch.train.train_step import init_train_state, loss_fn
    from lightly_ocr_tpu_torch.train.trainer import encode_batch

    runs, rect = {}, {}
    for name, where, dt, ref in (("cpu64", "cpu", torch.float64, None), ("cpu", "cpu", torch.float32, None),
                                 ("card", dev, torch.float32, "cpu"), ("card64", dev, torch.float64, "cpu64")):
        model, _ = init_train_state(cfg, SEED, where)
        model.to(dt)
        if model.Transformation is not None:
            def feed(m, i, o, name=name, ref=ref):
                rect[name] = o.detach().cpu()
                if ref is None:
                    return None
                return o + (rect[ref].to(o.device) - o).detach()  # straight through
            model.Transformation.register_forward_hook(feed)
        batch = encode_batch(cfg, build_converter(cfg.prediction, cfg.character), images, labels,
                             where)
        batch["images"] = batch["images"].to(dt)
        t = time.perf_counter()
        loss, _ = loss_fn(model, cfg, batch)
        loss.backward()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        runs[name] = (loss.item(), {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()},
                      time.perf_counter() - t)
        del model
    runs["rect"] = rect
    return runs


def train_gates(runs: dict) -> tuple[str, list]:
    """Phase ``train`` (a)'s gates on :func:`train_grads`' runs: -> (a line
    of the readings, the gates that failed).  float32: the loss within
    TRAIN_LOSS_TOL of the CPU's; each gradient held to the CPU's float64
    one as the CPU's own float32 gradient is (in float32 a BatchNorm scale's
    gradient, a sum of ~200,000 products that mostly cancel, is ~1e-2 off
    the float64 one on either device).  float64: the loss within
    TRAIN_LOSS64_TOL and each gradient within TRAIN_GRAD64_TOL of the CPU's
    (TRAIN_GRAD64_TPS_TOL in the TPS rectifier, whose grid is float32 in
    every dtype); the rectified images within 1e-4 of the CPU's."""
    (l64, g64, _), (lc, g32, _), (lg, gg, _), (lg64, gg64, _) = (
        runs[k] for k in ("cpu64", "cpu", "card", "card64"))
    rect = runs["rect"]

    def rel(g, n):
        return ((g[n] - g64[n]).norm() / g64[n].norm().clamp_min(1e-30)).item()

    bound = {n: max(TRAIN_GRAD_TOL, TRAIN_GRAD_FACTOR * rel(g32, n)) for n in g64}
    bound64 = {n: TRAIN_GRAD64_TPS_TOL if n.startswith("Transformation.") else TRAIN_GRAD64_TOL for n in g64}
    worst = max(g64, key=lambda n: rel(gg, n) / bound[n])
    worst64 = max(g64, key=lambda n: rel(gg64, n) / bound64[n])
    cpu_worst = max(g64, key=lambda n: rel(g32, n))
    loss_err, loss64_err = abs(lg - lc) / abs(lc), abs(lg64 - l64) / abs(l64)
    rect_err = max(((rect[a] - rect[b]).abs().max() / rect[b].abs().max()).item()
                   for a, b in (("card", "cpu"), ("card64", "cpu64"))) if rect else 0.0
    line = (f"loss {lg:.6f} vs {lc:.6f} (rel {loss_err:.2e}, tol {TRAIN_LOSS_TOL}; float64 {l64:.6f}, the "
            f"card's {loss64_err:.2e} off, tol {TRAIN_LOSS64_TOL}); gradients against the CPU's float64, "
            f"rel L2: the card's float32 worst against its bound {worst} {rel(gg, worst):.2e} (bound "
            f"{bound[worst]:.2e} = max({TRAIN_GRAD_TOL}, {TRAIN_GRAD_FACTOR} x the CPU float32's "
            f"{rel(g32, worst):.2e})); its largest {max(rel(gg, n) for n in g64):.2e}, the CPU float32's "
            f"largest {rel(g32, cpu_worst):.2e} ({cpu_worst}); the card's float64 worst against its bound "
            f"{worst64} {rel(gg64, worst64):.2e} (bound {bound64[worst64]:.0e}), its largest outside the "
            f"rectifier {max([rel(gg64, n) for n in g64 if not n.startswith('Transformation.')]):.2e}; "
            f"over {len(g64)} tensors; rectified image card vs CPU {rect_err:.2e} of its max (tol 1e-4)")
    failed = [gate for gate, ok in (
        ("loss float32", loss_err <= TRAIN_LOSS_TOL), ("loss float64", loss64_err <= TRAIN_LOSS64_TOL),
        ("rectified image", rect_err <= 1e-4),
        (f"gradient float32 {worst}", rel(gg, worst) <= bound[worst]),
        (f"gradient float64 {worst64}", rel(gg64, worst64) <= bound64[worst64])) if not ok]
    return line, failed


def train_parity(cfg, images: np.ndarray, labels: list, smi: str, dev: str) -> None:
    """Phase ``train`` (a): :func:`train_grads` held by :func:`train_gates`."""
    runs = train_grads(cfg, images, labels, dev)
    line, failed = train_gates(runs)
    log(f"train {cfg.prediction} b{len(labels)} card vs CPU: {line}; first forward+backward "
        f"{runs['card'][2]:.2f} s card, {runs['cpu'][2]:.2f} s CPU; on {smi}")
    assert not failed, f"train: the card's step is off: {failed}"


def trainer_cli(base, work: str, train_root: str, val_root: str, smi: str, dev: str) -> dict:
    """Phase ``train`` (b): the trainer's entry point as users start it, a
    subprocess on the card; returns what its log shows."""
    log_dir = os.path.join(work, "logs")
    cfg_path = os.path.join(work, "train.json")  # JSON is YAML too; the card has no pyyaml
    with open(cfg_path, "w") as f:
        json.dump({**base.to_dict(), "batch_size": TRAIN_BATCH, "num_epochs": 1000,
                   "val_interval": TRAIN_LOG_EVERY, "save_interval": TRAIN_SAVE_EVERY, "log_dir": log_dir,
                   "workers": 2, "seeds": SEED}, f)
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
    cmd = [sys.executable, "-m", "lightly_ocr_tpu_torch.train.trainer", "--config", cfg_path,
           "--train-root", train_root, "--val-root", val_root, "--num-iters", str(TRAIN_ITERS)]
    if dev != "cuda":  # the default device is the card
        cmd += ["--device", dev]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True, text=True,
                          timeout=TRAIN_DEADLINE_S)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, f"trainer exited {proc.returncode}:\n{proc.stderr[-4000:]}"
    assert "Traceback" not in proc.stderr, "trainer: traceback in stderr:\n" + proc.stderr[-4000:]
    device_line = [ln for ln in proc.stdout.splitlines() if ln.startswith(f"training on device {dev}")]
    assert device_line, "trainer: its log does not name the cuda device:\n" + proc.stdout[-2000:]
    for step in (TRAIN_SAVE_EVERY, TRAIN_ITERS):
        assert os.path.isfile(os.path.join(log_dir, "checkpoints", str(step), "state.pt")), step
    assert os.path.isfile(os.path.join(log_dir, "best.json"))
    with open(os.path.join(log_dir, "log_train.txt")) as f:
        text = f.read()
    windows = [(int(a), float(b), float(c)) for a, b, c in re.findall(
        r"\[(\d+)/\d+\] train_loss: ([\d.]+) \| val_loss: ([\d.]+)", text)]
    accs = [float(a) for a in re.findall(r"^accuracy\s*: ([\d.]+)", text, re.M)]
    assert [w[0] for w in windows] == list(range(TRAIN_LOG_EVERY, TRAIN_ITERS + 1, TRAIN_LOG_EVERY)), windows
    first, last = windows[0][1], windows[-1][1]
    with open(os.path.join(log_dir, "best.json")) as f:
        best = json.load(f)
    log(f"train cli: {' '.join(cmd[1:3])} ... {TRAIN_ITERS} steps at b{TRAIN_BATCH} ({base.prediction}, "
        f"{base.transform}, Adam 1e-3) in {wall:.2f} s; {device_line[0]}; train_loss of steps 1-{TRAIN_LOG_EVERY} "
        f"{first:.4f}, of the last {TRAIN_LOG_EVERY} {last:.4f}; train_loss by {TRAIN_LOG_EVERY} steps "
        f"{[w[1] for w in windows]}; val loss {[w[2] for w in windows]}; val accuracy {accs}; best {best}; "
        f"on {smi}")
    assert last < 0.5 * first, "train cli: the loss did not halve"
    return {"log_dir": log_dir, "best": best}


def train_resume(cfg, log_dir: str, smi: str, dev: str) -> None:
    """Phase ``train`` (c): the first periodic checkpoint restored on the
    card equals what was saved, bit for bit: model, optimizer state, step."""
    from lightly_ocr_tpu_torch.train.train_step import init_train_state
    from lightly_ocr_tpu_torch.utils.checkpoint import load_state_file, restore_checkpoint

    ckpt = os.path.join(log_dir, "checkpoints")
    saved, _ = load_state_file(ckpt, TRAIN_SAVE_EVERY)
    _, state = init_train_state(cfg, SEED + 7, dev)
    state, step = restore_checkpoint(ckpt, state, TRAIN_SAVE_EVERY)
    model_sd, opt_sd = state.model.state_dict(), state.optimizer.state_dict()
    assert step == TRAIN_SAVE_EVERY == state.step == saved["step"]
    assert model_sd.keys() == saved["model"].keys()
    for k, v in saved["model"].items():
        assert torch.equal(model_sd[k].cpu(), v), f"resume: model {k} differs"
    n_state = 0
    for i, slots in saved["optimizer"]["state"].items():
        for name, v in slots.items():
            assert torch.equal(opt_sd["state"][i][name].cpu(), v.cpu()), f"resume: optimizer {i}.{name}"
            n_state += 1
    assert opt_sd["param_groups"] == saved["optimizer"]["param_groups"], "resume: param groups"
    log(f"train resume: step-{step} checkpoint restored on the card equal bit for bit "
        f"({len(model_sd)} model tensors, {n_state} optimizer tensors, step {step}); on {smi}")


def train_bridge(cfg, log_dir: str, records: str, smi: str, dev: str) -> None:
    """Phase ``train`` (d): the best checkpoint's state dict in the
    per-image recognizer on the card (strict load), reading 8 training
    crops."""
    from lightly_ocr_tpu_torch.data.loader import align_collate
    from lightly_ocr_tpu_torch.data.records import RecordDataset
    from lightly_ocr_tpu_torch.engines import CRNN
    from lightly_ocr_tpu_torch.utils.checkpoint import load_variables_for_inference

    sd = load_variables_for_inference(os.path.join(log_dir, "best_acc"))
    engine = CRNN(cfg, state_dict=sd, device=dev)
    ds = RecordDataset(records, character=cfg.character, batch_max_len=cfg.batch_max_len)
    crops, labels = align_collate([ds[i] for i in range(8)], cfg.height, cfg.width, cfg.keep_ratio)
    ds.close()
    texts, conf = engine.recognize_crops(crops)
    log(f"train bridge: engines.CRNN(state_dict=best checkpoint) on the card reads "
        f"{list(zip(labels, texts))}, confidences {np.round(conf, 3).tolist()}; on {smi}")
    assert len(texts) == 8 and all(isinstance(t, str) for t in texts)


def train_speed(base, records: str, smi: str, dev: str) -> None:
    """Phase ``train`` (e): ms a train step (median of TRAIN_SPEED_STEPS
    after 3 warm-up steps, host clock around a synchronise), samples/s and
    peak memory at full width (``Config()``: Attention, TPS, Adadelta), TF32
    off; CUDA kernels a step and the top 5 by device time (torch.profiler,
    one step); and the loader's ms a batch on the host."""
    from lightly_ocr_tpu_torch.config import Config
    from lightly_ocr_tpu_torch.data.loader import DataLoader
    from lightly_ocr_tpu_torch.data.records import RecordDataset
    from lightly_ocr_tpu_torch.text.converters import build_converter
    from lightly_ocr_tpu_torch.train.trainer import encode_batch
    from lightly_ocr_tpu_torch.train.train_step import (
        clip_by_global_norm_,
        init_train_state,
        loss_fn,
        make_train_step,
    )

    def split_ms(model, state, cfg, batch) -> list:
        """ms of the forward, the backward and the clip + optimizer step of
        one step (CUDA events; plain steps only)."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        state.optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        loss, _ = loss_fn(model, cfg, batch)
        ev[1].record()
        loss.backward()
        ev[2].record()
        clip_by_global_norm_([p.grad for p in model.parameters() if p.grad is not None], cfg.grad_clip)
        state.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

    ds = RecordDataset(records, character=Config().character, batch_max_len=25)
    loader = DataLoader(ds, batch_size=TRAIN_BATCH, keep_ratio=True, seed=SEED, workers=2)
    t = time.perf_counter()
    n = sum(1 for _ in loader)
    load_ms = 1e3 * (time.perf_counter() - t) / n
    pool = [ds[i] for i in range(len(ds))]
    ds.close()
    log(f"train loader: {load_ms:.2f} ms a b{TRAIN_BATCH} batch on the host (2 threads, PNG decode "
        f"in numpy + bicubic resize, {n} batches); host of {smi}")
    att = base.replace(adam=Config().adam, lr=Config().lr)  # Config()'s optimizer: Adadelta
    ctc = att.replace(prediction="CTC")
    cases = [("attention b64", att, 64), ("ctc b64", ctc, 64),
             ("attention b192", att, 192), ("ctc b192", ctc, 192),
             ("attention b64 remat", att.replace(train_remat=True), 64),
             ("attention b64 grad_accum=2", att.replace(grad_accum=2), 64)]
    from lightly_ocr_tpu_torch.data.loader import align_collate

    for name, cfg, B in cases:
        images, labels = align_collate([pool[i % len(pool)] for i in range(B)], keep_ratio=True)
        batch = encode_batch(cfg, build_converter(cfg.prediction, cfg.character), images, labels, dev)
        accum = max(1, cfg.grad_accum)
        gc.collect()
        torch.cuda.empty_cache()
        base_mem = torch.cuda.memory_allocated()  # what earlier phases still hold
        model, state = init_train_state(cfg, SEED, dev)
        step = make_train_step(model, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            step(state, batch)
        times = []
        for _ in range(TRAIN_SPEED_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        assert np.isfinite(metrics["loss"].item())
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            step(state, batch)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        n_kernels = sum(e.count for e in kern)
        busy = sum(e.device_time_total for e in kern) / 1e3
        top = sorted(kern, key=lambda e: e.device_time_total, reverse=True)[:5]
        ms = 1e3 * float(np.median(times))
        split = ""
        if accum == 1 and not cfg.train_remat:
            parts = np.median([split_ms(model, state, cfg, batch) for _ in range(5)], axis=0)
            split = (f"; forward {parts[0]:.3f}, backward {parts[1]:.3f}, clip + optimizer "
                     f"{parts[2]:.3f} ms (CUDA events, median of 5)")
        log(f"train speed {name}: {ms:.3f} ms a step (median of {TRAIN_SPEED_STEPS}; min "
            f"{1e3 * min(times):.3f}, max {1e3 * max(times):.3f}; host clock), {B / ms * 1e3:.1f} "
            f"samples/s, peak memory {peak:.2f} GiB above the {base_mem / 2 ** 30:.2f} held before; "
            f"{n_kernels} CUDA kernels a step, {busy:.3f} ms of device time (torch.profiler){split}; loader {load_ms / TRAIN_BATCH * B / ms:.1%} of a step; "
            f"on {smi}")
        log(f"train speed {name} kernels by device time: "
            + "; ".join(f"{e.key[:60]} x{e.count} {e.device_time_total / 1e3:.3f} ms" for e in top)
            + f" on {smi}")
        del model, state, step, batch


def png_unfilter_words(smi: str) -> None:
    """The numpy PNG decode of a word record, one row filter at a time (PIL
    writes word records with a mix of Up, Paeth and Sub rows)."""
    from lightly_ocr_tpu_torch.data.records import encode_png
    from lightly_ocr_tpu_torch.serving.upload import decode_png

    rng = np.random.default_rng(SEED)
    font = glyph_font("abcdefghij", SEED)
    img = np.concatenate([word_image("abcdefghij", font, rng)] * 2, axis=1)[:, :200]  # 32x200 gray
    parts = []
    for filt, fname in enumerate(("None", "Sub", "Up", "Average", "Paeth")):
        data = encode_png(img, filt)
        assert (decode_png(data)[..., 0] == img).all(), fname
        t = time.perf_counter()
        for _ in range(20):
            decode_png(data)
        parts.append(f"{fname} {1e3 * (time.perf_counter() - t) / 20:.3f}")
    log(f"numpy PNG decode ms of a 32x200 gray word by row filter: {', '.join(parts)} "
        f"(host of {smi})")


def train_phase(smi: str, dev: str = "cuda", base=None) -> None:
    """Phase ``train``: (a) card vs CPU, (b) the trainer CLI, (c) resume,
    (d) the bridge into ``engines.CRNN``, (e) speed; on ``Config()`` (or
    ``base``, for a rehearsal on the CPU) with Adam at 1e-3."""
    from lightly_ocr_tpu_torch.config import Config
    from lightly_ocr_tpu_torch.data.loader import align_collate
    from lightly_ocr_tpu_torch.data.records import RecordDataset

    cfg = (base or Config()).replace(adam=True, lr=1e-3)
    work = tempfile.mkdtemp(prefix="lightly_ocr_train_")
    try:
        font = glyph_font(cfg.character, SEED)
        train_root, val_root = os.path.join(work, "train.lor"), os.path.join(work, "val.lor")
        word_records(train_root, TRAIN_WORDS, font, TRAIN_ALPHABET, SEED)
        word_records(val_root, VAL_WORDS, font, TRAIN_ALPHABET, SEED + 1)
        ds = RecordDataset(train_root, character=cfg.character, batch_max_len=cfg.batch_max_len)
        images, labels = align_collate([ds[i] for i in range(TRAIN_BATCH)], keep_ratio=True)
        ds.close()
        t0 = time.perf_counter()
        for head in ("Attention", "CTC"):
            train_parity(cfg.replace(prediction=head), images, labels, smi, dev)
        log(f"phase train (a) parity: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        # the CLI trains the demo recognizer's topology, the CTC head
        # without TPS: from scratch it starts reading the glyphs within 200
        # steps.  Config()'s TPS + attention stays near the letters' prior
        # for hundreds of steps on these records, in the JAX package's
        # trainer as in the port's (scripts/torch_train_curves.py: the
        # same init and batches on the CPU, the two curves within the
        # spread that round-off alone makes)
        cli_cfg = cfg.replace(prediction="CTC", transform="None")
        out = trainer_cli(cli_cfg, work, train_root, val_root, smi, dev)
        log(f"phase train (b) cli: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        train_resume(cli_cfg, out["log_dir"], smi, dev)
        train_bridge(cli_cfg, out["log_dir"], train_root, smi, dev)
        log(f"phase train (c, d) resume, bridge: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        png_unfilter_words(smi)
        train_speed(cfg, train_root, smi, dev)
        log(f"phase train (e) speed: {time.perf_counter() - t0:.2f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def det_receipt(rng: np.random.Generator, h: int, w: int) -> tuple:
    """A receipt of glyph words (dark stroke blocks, as ``synthesize_batch``
    draws them) on paper noise: (uint8 RGB [h, w, 3], [{"rect": [r0, c0, r1,
    c1], "text": ...}] of its words, one line after another)."""
    paper = 235 + rng.standard_normal((h, w)) * 4
    words = []
    y = int(rng.integers(8, 20))
    while True:
        ch_h = int(rng.integers(14, 26))
        if y + ch_h > h - 8:
            break
        x = int(rng.integers(6, 30))
        while True:
            n = int(rng.integers(2, 8))
            ch_w = int(rng.integers(9, max(10, ch_h)))
            gap = max(2, ch_w // 4)
            ww = n * ch_w + (n - 1) * gap
            if x + ww > w - 6:
                break
            for i in range(n):
                cc = x + i * (ch_w + gap)
                glyph = 30 + rng.random((ch_h, ch_w)) * 70
                glyph[2:-2, 2:-2] = np.where(rng.random((ch_h - 4, ch_w - 4)) < 0.4, glyph[2:-2, 2:-2], 220)
                paper[y:y + ch_h, cc:cc + ch_w] = glyph
            words.append({"rect": [y, x, y + ch_h, x + ww],
                          "text": "".join(rng.choice(list("abcdefghij"), size=n))})
            x += ww + int(rng.integers(12, 30))
        y += ch_h + int(rng.integers(10, 30))
    return np.repeat(np.clip(paper, 0, 255).astype(np.uint8)[..., None], 3, -1), words


def craft_grads(host: dict, dev: str) -> dict:
    """One forward and backward of ``VGG_UNet`` from ``init_craft_state``'s
    seeded init on ``host`` (a ``synthesize_batch``), on the CPU in float64
    (the reference) and float32 and on ``dev`` in float32 and float64:
    ``{run: (loss, {name: gradient}, [OHEM positives, hard negatives of
    each map], seconds)}``."""
    from lightly_ocr_tpu_torch.train.craft import batch_to, init_craft_state, ohem_masks, ohem_mse

    runs = {}
    for name, where, dt in (("cpu64", "cpu", torch.float64), ("cpu", "cpu", torch.float32),
                            ("card", dev, torch.float32), ("card64", dev, torch.float64)):
        model, _ = init_craft_state(SEED, device=where)
        model.to(dt)
        b = batch_to(host, where)
        t = time.perf_counter()
        maps, _ = model(b["images"].to(dt))
        maps = maps.to(torch.promote_types(maps.dtype, torch.float32))
        loss = ohem_mse(maps[..., 0], b["region"]) + ohem_mse(maps[..., 1], b["affinity"])
        loss.backward()
        masks = [m.cpu() for i, k in enumerate(("region", "affinity"))
                 for m in ohem_masks(maps[..., i].detach(), b[k])[1:]]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        runs[name] = (loss.item(), {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()},
                      masks, time.perf_counter() - t)
        del model, maps, loss
    return runs


def craft_gates(runs: dict) -> tuple[str, list]:
    """Phase ``craft`` (a)'s gates: -> (a line of the readings, the gates
    that failed).  float32: the loss and each gradient against the CPU's
    float64 within max(TRAIN_GRAD_TOL, TRAIN_GRAD_FACTOR x the CPU
    float32's own distance); float64: the loss within CRAFT_LOSS64_TOL and
    each gradient within CRAFT_GRAD64_TOL; the OHEM masks of each map equal
    on both sides in either dtype.  A gradient that is zero in the float64
    reference (the bias of a conv that feeds a BatchNorm) is held to zero:
    its norm within CRAFT_ZERO64 (float64) or max(CRAFT_ZERO32,
    TRAIN_GRAD_FACTOR x the CPU float32's) of the global norm."""
    (l64, g64, m64, _), (lc, g32, mc, _), (lg, gg, mg, _), (lg64, gg64, mg64, _) = (
        runs[k] for k in ("cpu64", "cpu", "card", "card64"))
    total = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in g64.values()])))
    zero = {n for n, g in g64.items() if g.norm() < CRAFT_ZERO64 * total}

    def rel(g, n):
        return ((g[n] - g64[n]).norm() / g64[n].norm()).item()

    def size(g, n):  # a zero gradient's norm over the global one
        return (g[n].norm() / total).item()

    live = [n for n in g64 if n not in zero]
    bound = {n: max(TRAIN_GRAD_TOL, TRAIN_GRAD_FACTOR * rel(g32, n)) for n in live}
    bound0 = {n: max(CRAFT_ZERO32, TRAIN_GRAD_FACTOR * size(g32, n)) for n in zero}
    worst = max(live, key=lambda n: rel(gg, n) / bound[n])
    worst64 = max(live, key=lambda n: rel(gg64, n))
    worst0 = max(zero, key=lambda n: size(gg, n) / bound0[n]) if zero else None
    zero64 = max((size(gg64, n) for n in zero), default=0.0)
    loss_err, loss_cpu_err = abs(lg - l64) / abs(l64), abs(lc - l64) / abs(l64)
    loss_bound = max(TRAIN_GRAD_TOL, TRAIN_GRAD_FACTOR * loss_cpu_err)
    loss64_err = abs(lg64 - l64) / abs(l64)
    flips32 = [int((a != b).sum()) for a, b in zip(mg, mc)]
    flips64 = [int((a != b).sum()) for a, b in zip(mg64, m64)]
    line = (f"loss {lg:.6f} vs the CPU's float64 {l64:.6f} (rel {loss_err:.2e}, bound {loss_bound:.2e}; the "
            f"CPU float32's {loss_cpu_err:.2e}; float64 on the card {loss64_err:.2e} off, tol "
            f"{CRAFT_LOSS64_TOL}); gradients against the CPU's float64, rel L2: the card's float32 worst "
            f"against its bound {worst} {rel(gg, worst):.2e} (bound {bound[worst]:.2e}), its largest "
            f"{max(rel(gg, n) for n in live):.2e}, the CPU float32's largest {max(rel(g32, n) for n in live):.2e}; "
            f"the card's float64 worst {worst64} {rel(gg64, worst64):.2e} (tol {CRAFT_GRAD64_TOL}); "
            f"{len(zero)} zero gradients (conv biases before a BatchNorm), their largest norm over the global "
            f"{total:.4f}: card float32 {size(gg, worst0) if zero else 0.0:.2e} (bound "
            f"{bound0[worst0] if zero else 0.0:.2e}), card float64 {zero64:.2e} (tol {CRAFT_ZERO64}); "
            f"over {len(g64)} tensors; OHEM masks (region pos, hard neg, affinity pos, hard neg) "
            f"{[int(m.sum()) for m in m64]} pixels, card vs CPU differ at float32 {flips32}, float64 {flips64}")
    failed = [gate for gate, ok in (
        ("loss float32", loss_err <= loss_bound), ("loss float64", loss64_err <= CRAFT_LOSS64_TOL),
        (f"gradient float32 {worst}", rel(gg, worst) <= bound[worst]),
        (f"gradient float64 {worst64}", rel(gg64, worst64) <= CRAFT_GRAD64_TOL),
        (f"zero gradient float32 {worst0}", not zero or size(gg, worst0) <= bound0[worst0]),
        ("zero gradient float64", zero64 <= CRAFT_ZERO64),
        ("OHEM masks float32", not any(flips32)), ("OHEM masks float64", not any(flips64))) if not ok]
    return line, failed


def craft_parity(smi: str, dev: str) -> None:
    """Phase ``craft`` (a): one step's loss, gradients and OHEM masks, card
    against CPU (:func:`craft_gates`); and a step with ``freeze=("slice1",)``
    on the card: slice1's parameters unchanged, its BatchNorm running means
    moved, the decoder moved."""
    from lightly_ocr_tpu_torch.train.craft import batch_to, init_craft_state, make_craft_train_step, synthesize_batch

    host = synthesize_batch(np.random.default_rng(SEED), CRAFT_PARITY_B, *CRAFT_PARITY_HW)
    runs = craft_grads(host, dev)
    line, failed = craft_gates(runs)
    log(f"craft b{CRAFT_PARITY_B} {CRAFT_PARITY_HW[0]}x{CRAFT_PARITY_HW[1]} card vs CPU: {line}; first "
        f"forward+backward {runs['card'][3]:.2f} s card, {runs['cpu'][3]:.2f} s CPU; on {smi}")
    assert not failed, f"craft: the card's step is off: {failed}"
    model, state = init_craft_state(SEED, device=dev, freeze=("slice1",))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, metrics = make_craft_train_step(model, freeze=("slice1",))(state, batch_to(host, dev))
    after = model.state_dict()
    s1 = [k for k in after if k.startswith("basenet.slice1.")]
    pinned = [k for k in s1 if not k.endswith(("running_mean", "running_var"))]
    assert all(torch.equal(after[k], before[k]) for k in pinned), "craft freeze: slice1 moved"
    means = [k for k in s1 if k.endswith("running_mean")]
    assert all(not torch.equal(after[k], before[k]) for k in means), "craft freeze: slice1 statistics held"
    assert not torch.equal(after["upconv1.conv.0.weight"], before["upconv1.conv.0.weight"])
    log(f"craft freeze slice1 on the card: {len(pinned)} slice1 parameters unchanged, {len(means)} running "
        f"means moved; loss {metrics['loss'].item():.6f}, raw grad norm {metrics['grad_norm'].item():.4f} "
        f"(frozen gradients in it, out of the clip); on {smi}")


def craft_cli(work: str, smi: str, dev: str) -> dict:
    """Phase ``craft`` (b): detection records of CRAFT_RECEIPTS receipts
    (drawn in numpy, PNG without PIL), then ``python -m
    lightly_ocr_tpu_torch.train.trainer --model CRAFT --records ...`` as a
    subprocess on the card; the loss must fall and the held-out region IoU
    must rise.  Returns the checkpoint directory and the records."""
    from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
    from lightly_ocr_tpu_torch.train.craft import init_craft_state
    from lightly_ocr_tpu_torch.train.pseudo_labels import (
        batches_from_records,
        eval_region_iou,
        write_detection_records,
    )
    from lightly_ocr_tpu_torch.utils.checkpoint import load_variables_for_inference

    rng = np.random.default_rng(SEED)
    records, held_out = os.path.join(work, "det.lor"), os.path.join(work, "held_out.lor")
    t = time.perf_counter()
    write_detection_records(records, (det_receipt(rng, *CRAFT_REC_HW) for _ in range(CRAFT_RECEIPTS)))
    write_detection_records(held_out, (det_receipt(rng, *CRAFT_REC_HW) for _ in range(CRAFT_HELD_OUT)))
    write_s = time.perf_counter() - t
    held = next(batches_from_records(held_out, CRAFT_HELD_OUT, *CRAFT_REC_HW, np.random.default_rng(SEED + 1)))
    model0, _ = init_craft_state(SEED, device=dev)  # the CLI's init (its --seed is SEED)
    iou0 = eval_region_iou(model0, held, CRAFT_IOU_THRESH)
    del model0
    ckpt = os.path.join(work, "craft_ckpt")
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
    cmd = [sys.executable, "-m", "lightly_ocr_tpu_torch.train.trainer", "--model", "CRAFT", "--records", records,
           "--num-steps", str(CRAFT_STEPS), "--batch", str(CRAFT_BATCH), "--height", str(CRAFT_REC_HW[0]),
           "--width", str(CRAFT_REC_HW[1]), "--seed", str(SEED), "--log-every", str(CRAFT_LOG_EVERY),
           "--checkpoint-dir", ckpt]
    if dev != "cuda":  # the default device is the card
        cmd += ["--device", dev]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True, text=True, timeout=CRAFT_DEADLINE_S)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, f"craft trainer exited {proc.returncode}:\n{proc.stderr[-4000:]}"
    assert "Traceback" not in proc.stderr, "craft trainer: traceback in stderr:\n" + proc.stderr[-4000:]
    device_line = [ln for ln in proc.stdout.splitlines() if ln.startswith(f"craft training on device {dev}")]
    assert device_line, "craft trainer: its log does not name the device:\n" + proc.stdout[-2000:]
    logged = [float(x) for x in re.findall(r"craft step \d+/\d+ loss ([\d.]+)", proc.stdout)]
    final = re.search(r"final loss ([\d.]+) \(first ([\d.]+)\)", proc.stdout)
    assert final and len(logged) == CRAFT_STEPS // CRAFT_LOG_EVERY, proc.stdout[-2000:]
    last, first = float(final.group(1)), float(final.group(2))
    model1 = VGG_UNet()
    model1.load_state_dict(load_variables_for_inference(ckpt), strict=True)
    iou1 = eval_region_iou(model1.to(dev), held, CRAFT_IOU_THRESH)
    log(f"craft cli: {' '.join(cmd[1:5])} ... {CRAFT_STEPS} steps at b{CRAFT_BATCH} "
        f"{CRAFT_REC_HW[0]}x{CRAFT_REC_HW[1]} on {CRAFT_RECEIPTS} receipts ({write_s:.2f} s to draw and "
        f"write them) in {wall:.2f} s; {device_line[0]}; loss of step 1 {first:.5f}, of step {CRAFT_STEPS} "
        f"{last:.5f}; loss every {CRAFT_LOG_EVERY} steps {logged}; held-out region IoU at "
        f"{CRAFT_IOU_THRESH}: init {iou0:.4f}, trained {iou1:.4f}; on {smi}")
    assert last < first, "craft cli: the loss did not fall"
    assert iou1 > iou0, "craft cli: the held-out region IoU did not rise"
    return {"ckpt": ckpt, "records": records}


def craft_serve(ckpt: str, smi: str, dev: str) -> None:
    """Phase ``craft`` (c): the trained checkpoint (strict loads) in
    ``engines.CRAFT`` (float32) and in ``BatchedOCR`` (bf16 ``tail,s2d``, a
    seeded CTC recognizer), one dispatch of BATCH receipts at 600x400
    (960x640 canvases); kernels #1, #2 and #5 must launch in it."""
    from lightly_ocr_tpu_torch.config import Config
    from lightly_ocr_tpu_torch.engines import CRAFT
    from lightly_ocr_tpu_torch.models.crnn import CRNNet
    from lightly_ocr_tpu_torch.models.layers import init_module
    from lightly_ocr_tpu_torch.serving.batch import BatchedOCR
    from lightly_ocr_tpu_torch.utils.checkpoint import load_variables_for_inference

    sd = load_variables_for_inference(ckpt)
    cfg = Config(prediction="CTC", transform="None", compute_dtype="bfloat16", quant_int8=False,
                 max_boxes=BOXES)
    rec_sd = init_module(CRNNet(cfg), torch.Generator().manual_seed(SEED)).state_dict()
    rng = np.random.default_rng(SEED + 2)
    imgs = [det_receipt(rng, RECEIPT_H, RECEIPT_W)[0] for _ in range(BATCH)]
    engine = CRAFT(cfg, state_dict=sd, device=dev)
    eng = [engine.detect_rects(im) for im in imgs]
    ocr = BatchedOCR(cfg, sd, rec_sd, boxes_per_image=BOXES, device=dev)
    (cb, _), _ = next(iter(ocr.group(imgs).items()))
    ocr.run_images(imgs[:2])  # warm
    reset_launch_counts()
    out = ocr.run_images(imgs)
    launches = launch_counts()
    bat = [[it["rect"] for it in items] for items in out]
    ious = [np.mean([max(rect_iou(r, e) for e in es) for r in bs]) for bs, es in zip(bat, eng) if len(bs) and len(es)]
    log(f"craft serve: the trained checkpoint, b{BATCH} receipts {RECEIPT_H}x{RECEIPT_W} on {cb[0]}x{cb[1]} "
        f"canvases: boxes per receipt engines.CRAFT float32 {[len(e) for e in eng]}, BatchedOCR bf16 "
        f"tail,s2d {[len(b) for b in bat]}; mean box IoU of the batched path against the engine "
        f"{float(np.mean(ious)) if ious else float('nan'):.4f} over {len(ious)} receipts with boxes on both; "
        f"launches {launches}; on {smi}")
    for k in ("seam_tail", "cc", "conv12_pool"):
        assert launches[k] > 0, f"craft serve: {k} did not launch: {launches}"


def craft_speed(records: str, smi: str, dev: str) -> None:
    """Phase ``craft`` (d): the train step of ``train_craft`` at each of
    CRAFT_SPEED (float32, TF32 off): ms a step (median of CRAFT_SPEED_STEPS
    after 3 warm-up steps, host clock around a synchronise), samples/s, the
    device's time of one step and its CUDA kernels (torch.profiler), the
    forward, OHEM loss, backward and clip + Adam by CUDA events, peak memory,
    the forward by module, and the bound: ``flop_counter``'s FLOPs of
    forward and backward over the float32 peak; at the first size also the
    step with ``torch.backends.cudnn.benchmark`` on.  Then the pseudo-label loader's host ms a b8 batch at
    960x640 from the records, split by stage."""
    from torch.utils.flop_counter import FlopCounterMode

    from lightly_ocr_tpu_torch.data.loader import resize_bilinear_uint8
    from lightly_ocr_tpu_torch.data.records import RecordDataset
    from lightly_ocr_tpu_torch.train.craft import (
        apply_craft_update,
        batch_to,
        craft_loss,
        init_craft_state,
        make_craft_train_step,
        ohem_mse,
        synthesize_batch,
    )
    from lightly_ocr_tpu_torch.train.pseudo_labels import (
        _decode_sample,
        batches_from_records,
        char_boxes_from_word,
        render_craft_targets,
    )

    rng = np.random.default_rng(SEED)
    for B, H, W in CRAFT_SPEED:
        batch = batch_to(synthesize_batch(rng, B, H, W), dev)
        gc.collect()
        torch.cuda.empty_cache()
        base_mem = torch.cuda.memory_allocated()
        model, state = init_craft_state(SEED, device=dev)
        step = make_craft_train_step(model)
        params = list(model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            step(state, batch)
        times = []
        for _ in range(CRAFT_SPEED_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        assert np.isfinite(metrics["loss"].item())
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            step(state, batch)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        n_kernels = sum(e.count for e in kern)
        busy = sum(e.device_time_total for e in kern) / 1e3
        top = sorted(kern, key=lambda e: e.device_time_total, reverse=True)[:5]
        parts = []
        for _ in range(5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            state.optimizer.zero_grad(set_to_none=True)
            ev[0].record()
            maps, _ = model(batch["images"])
            ev[1].record()
            loss = ohem_mse(maps[..., 0].float(), batch["region"]) + ohem_mse(maps[..., 1].float(), batch["affinity"])
            ev[2].record()
            loss.backward()
            ev[3].record()
            apply_craft_update(state.optimizer, params, [False] * len(params))
            ev[4].record()
            torch.cuda.synchronize()
            parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
        parts = np.median(parts, axis=0)
        state.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():  # the forward by module (cuDNN picks its algorithms per shape)
            fwd = module_ms(model.basenet, [f"slice{i}" for i in range(1, 6)], lambda: model(batch["images"]))
            fwd.update(module_ms(model, ["upconv1", "upconv2", "upconv3", "upconv4", "conv_cls"],
                                 lambda: model(batch["images"])))
        bench = ""
        if (B, H, W) == CRAFT_SPEED[0]:  # what cuDNN's autotuner would pick (not set by the port)
            torch.backends.cudnn.benchmark = True
            try:
                for _ in range(3):
                    step(state, batch)
                tb = []
                for _ in range(CRAFT_SPEED_STEPS):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    step(state, batch)
                    torch.cuda.synchronize()
                    tb.append(time.perf_counter() - t)
            finally:
                torch.backends.cudnn.benchmark = False
            bench = (f"; with torch.backends.cudnn.benchmark on (not the port's setting) "
                     f"{1e3 * float(np.median(tb)):.3f} ms a step, {B / float(np.median(tb)):.2f} samples/s")
        with FlopCounterMode(display=False) as fc:
            craft_loss(model, batch).backward()
        flops = fc.get_total_flops()
        state.optimizer.zero_grad(set_to_none=True)
        ms = 1e3 * float(np.median(times))
        bound = 1e3 * flops / PEAK_FP32_FLOPS
        log(f"craft speed b{B} {H}x{W}: {ms:.3f} ms a step (median of {CRAFT_SPEED_STEPS}; min "
            f"{1e3 * min(times):.3f}, max {1e3 * max(times):.3f}; host clock), {B / ms * 1e3:.2f} samples/s; "
            f"device {busy:.3f} ms, {n_kernels} CUDA kernels a step (torch.profiler); forward {parts[0]:.3f}, "
            f"OHEM loss {parts[1]:.3f}, backward {parts[2]:.3f}, clip + Adam {parts[3]:.3f} ms (CUDA events, "
            f"median of 5); peak memory {peak:.2f} GiB above the {base_mem / 2 ** 30:.2f} held before; "
            f"{flops / 1e12:.3f} TFLOP forward + backward (flop_counter), bound {bound:.3f} ms at "
            f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s float32 ({bound / ms:.1%} of it); on {smi}")
        log(f"craft speed b{B} {H}x{W} forward by module ms (CUDA events, no grad): "
            + ", ".join(f"{k} {v:.3f}" for k, v in fwd.items()) + f"{bench}; on {smi}")
        log(f"craft speed b{B} {H}x{W} kernels by device time: "
            + "; ".join(f"{e.key[:60]} x{e.count} {e.device_time_total / 1e3:.3f} ms" for e in top)
            + f" on {smi}")
        del model, state, step, batch, params, maps, loss
    # the pseudo-label loader, b8 at 960x640 from the 320x256 records
    B, H, W = CRAFT_SPEED[0]
    it = batches_from_records(records, B, H, W, np.random.default_rng(SEED))
    next(it)
    t = time.perf_counter()
    for _ in range(3):
        next(it)
    batch_ms = 1e3 * (time.perf_counter() - t) / 3
    it.close()
    ds = RecordDataset(records, filtering=False)
    split = dict.fromkeys(("decode", "resize", "split", "render"), 0.0)
    for i in range(B):
        t0 = time.perf_counter()
        img, words = _decode_sample(*ds.raw(i))
        t1 = time.perf_counter()
        resized = resize_bilinear_uint8(img, W, H).astype(np.float32)
        t2 = time.perf_counter()
        gray = resized @ np.asarray([0.299, 0.587, 0.114], np.float32)
        sy, sx = H / img.shape[0], W / img.shape[1]
        boxes = [char_boxes_from_word(gray, (w["rect"][0] * sy, w["rect"][1] * sx, w["rect"][2] * sy,
                                             w["rect"][3] * sx), w["text"]) for w in words]
        t3 = time.perf_counter()
        render_craft_targets(H // 2, W // 2, boxes)
        t4 = time.perf_counter()
        for k, a, b in (("decode", t0, t1), ("resize", t1, t2), ("split", t2, t3), ("render", t3, t4)):
            split[k] += 1e3 * (b - a)
    ds.close()
    log(f"craft loader: {batch_ms:.2f} ms a b{B} {H}x{W} batch from {CRAFT_REC_HW[0]}x{CRAFT_REC_HW[1]} PNG "
        f"records on the host (one thread); a batch's parts: "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + f" ms; host of {smi}")


def craft_phase(smi: str, dev: str = "cuda") -> None:
    """Phase ``craft``: CRAFT detector training, (a) card vs CPU, (b) the
    trainer CLI on detection records, (c) the trained detector served,
    (d) speed; float32 with TF32 off."""
    work = tempfile.mkdtemp(prefix="lightly_ocr_craft_")
    try:
        t0 = time.perf_counter()
        craft_parity(smi, dev)
        log(f"phase craft (a) parity: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        out = craft_cli(work, smi, dev)
        log(f"phase craft (b) cli: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        craft_serve(out["ckpt"], smi, dev)
        log(f"phase craft (c) serve: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        craft_speed(out["records"], smi, dev)
        log(f"phase craft (d) speed: {time.perf_counter() - t0:.2f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    from lightly_ocr_tpu_torch.config import Config
    from lightly_ocr_tpu_torch.data.records import encode_png
    from lightly_ocr_tpu_torch.models.crnn import CRNNet
    from lightly_ocr_tpu_torch.models.layers import init_module
    from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
    from lightly_ocr_tpu_torch.ops import cc, native, seam_tail, stem
    from lightly_ocr_tpu_torch.serving.batch import BatchedOCR

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # -- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    build_s = native.build(["seam_tail", "cc", "stem"])
    for name, text in native.build_log.items():
        for line in text.splitlines():
            if any(k in line.lower() for k in ("registers", "spill", "error", "wgmma")):
                print(f"nvcc[{name}] {line.strip()}", file=sys.stderr)
    native.load("seam_tail", seam_tail._SIG)
    geo = seam_tail.kernel_geometry()
    assert geo == (seam_tail.STRIP_COLS, seam_tail.SEGMENT_ROWS, seam_tail.HALO), geo
    for w in (320, 640):
        assert cc.kernel_geometry(w) == cc.geometry(w), (w, cc.kernel_geometry(w))
    geo = stem.kernel_geometry()
    assert geo == stem.geometry(), geo
    log(f"phase build: {time.perf_counter() - t0:.2f} s (nvcc {build_s:.2f} s)")

    # -- model, seeded weights, receipts -----------------------------------
    t0 = time.perf_counter()
    cfg = Config(prediction="Attention", transform="TPS", max_boxes=BOXES,
                 compute_dtype="bfloat16", quant_int8=False)
    g = torch.Generator().manual_seed(SEED)
    det_sd = init_module(VGG_UNet(), g).state_dict()
    rec_sd = init_module(CRNNet(cfg), g).state_dict()
    ocr = BatchedOCR(cfg, det_sd, rec_sd, boxes_per_image=BOXES, device=dev)
    imgs = receipts(np.random.default_rng(SEED), BATCH)
    (cb, gb), _ = next(iter(ocr.group(imgs).items()))
    canv = ocr.prepare(imgs, cb, gb)[0]
    log(f"canvas {tuple(canv.shape)} gray bucket {gb}")
    log(f"phase setup: {time.perf_counter() - t0:.2f} s")

    # -- phase 2: seam tail kernel vs plain ---------------------------------
    t0 = time.perf_counter()
    p = ocr.tail
    with torch.inference_mode():
        y_lo, t = ocr.det_net.trunk(canv)
        t = t.contiguous()
        ya = torch.matmul(y_lo.float(), p.k1a).contiguous()
        got = seam_tail.seam_tail(ya, t, p)
        torch.cuda.synchronize()
        ref = seam_tail.seam_tail_plain(ya, t, p)
        torch.cuda.synchronize()
    B, H2, W2, _ = t.shape
    assert got.shape == (B, H2, 2, W2) and torch.isfinite(got).all(), "tail output"
    tail_err, fg_got = tail_gates("seam tail", got, ref)
    with torch.inference_mode():
        tail_ms = cuda_ms(lambda: seam_tail.seam_tail(ya, t, p), iters=10)
        tail_plain_ms = cuda_ms(lambda: seam_tail.seam_tail_plain(ya, t, p), iters=3)
        tail_lib_ms = cuda_ms(lambda: tail_library(ya, t, p), iters=10)
    tail_bound, tail_by = tail_bound_ms(B, H2, W2)
    log(f"seam tail ms: kernel {tail_ms:.3f} plain {tail_plain_ms:.3f} "
        f"library {tail_lib_ms:.3f} bound {tail_bound:.3f} ({tail_by})")
    # kernel #3: the chain alone, on the x that the legacy branch forms
    with torch.inference_mode():
        x = seam_tail._front(ya, t, p).contiguous()
        got3 = seam_tail.tail_scores(x, p)
        torch.cuda.synchronize()
        ref3 = seam_tail.tail_scores_plain(x, p)
        torch.cuda.synchronize()
    assert got3.shape == (B, H2, 2, W2) and torch.isfinite(got3).all(), "tail #3 output"
    chain_err, _ = tail_gates("tail chain #3", got3, ref3)
    del got3, ref3
    with torch.inference_mode():
        xn = x.permute(0, 3, 1, 2)
        chain_ms = cuda_ms(lambda: seam_tail.tail_scores(x, p), iters=10)
        chain_plain_ms = cuda_ms(lambda: seam_tail.tail_scores_plain(x, p), iters=3)
        chain_lib_ms = cuda_ms(lambda: chain_library(xn, p), iters=10)
    chain_bound, chain_by = chain_bound_ms(B, H2, W2)
    log(f"tail chain #3 ms: kernel {chain_ms:.3f} plain {chain_plain_ms:.3f} "
        f"library {chain_lib_ms:.3f} bound {chain_bound:.3f} ({chain_by})")
    del x, xn
    log(f"phase seam_tail: {time.perf_counter() - t0:.2f} s")

    # -- phase 3: connected components kernel vs plain ----------------------
    t0 = time.perf_counter()
    perc = np.random.default_rng(SEED).random((B, H2, W2)) < 0.59  # site percolation threshold
    cases = {"fg": fg_got.contiguous(),
             "spiral": torch.from_numpy(cc.spiral_mask(H2, W2)).to(dev)[None].contiguous(),
             "comb": torch.from_numpy(cc.comb_mask(H2, W2)).to(dev)[None].contiguous(),
             "percolation": torch.from_numpy(perc).to(dev)}
    cc_err = 0.0
    for name, fg in cases.items():
        lab = cc.label_components(fg)
        torch.cuda.synchronize()
        ref_lab = cc.label_components_plain(fg)
        cc_err = max(cc_err, (lab - ref_lab).abs().max().item())
        assert torch.equal(lab, ref_lab), f"CC kernel labels differ from plain on {name}"
        assert cc.labels_converged(fg, lab), f"CC labels not a fixed point on {name}"
        n_comp = int((lab.flatten(1) == torch.arange(H2 * W2, device=dev)).sum().item())
        log(f"cc {name}: {tuple(fg.shape)} labels equal, {n_comp} components")
    fg = cases["fg"]
    cc_ms = cuda_ms(lambda: cc.label_components(fg), iters=10)
    cc_graph_ms = graph_ms(lambda: cc.label_components(fg))
    cc_plain_ms = cuda_ms(lambda: cc.label_components_plain(fg), iters=3)
    sp = cases["spiral"]
    cc_spiral_ms = cuda_ms(lambda: cc.label_components(sp), iters=5)
    cc_bytes = fg.numel() * (1 + 4)
    cc_bound = 1e3 * cc_bytes / PEAK_BYTES
    log(f"cc ms: kernel {cc_ms:.3f} plain {cc_plain_ms:.3f} bound {cc_bound:.4f} (bytes); "
        f"spiral 1x{H2}x{W2} kernel {cc_spiral_ms:.3f}; kernel from a CUDA graph {cc_graph_ms:.4f}")
    # the split, on the device's clock: the launches up to each phase
    # replayed from a CUDA graph, less the ones before
    prefix_ms = [graph_ms(run) for _, run in cc.phase_prefixes(fg)]
    split = [t - (prefix_ms[i - 1] if i else 0.0) for i, t in enumerate(prefix_ms)]
    log("cc launches ms: " + ", ".join(f"{name} {t:.4f}" for name, t in zip(cc.PHASES, split))
        + f" (sum {prefix_ms[-1]:.4f}, CUDA graph)")
    log(f"phase cc: {time.perf_counter() - t0:.2f} s")

    # -- phase 4: conv1_2 kernels vs plain ------------------------------------
    t0 = time.perf_counter()
    stem_lines = stem_phase(ocr, canv)
    log(f"phase stem: {time.perf_counter() - t0:.2f} s")

    # -- phase 5: one dispatch of each other plan ----------------------------
    t0 = time.perf_counter()
    q = torch.quantile
    with torch.inference_mode():  # the first dispatch's maps set thresholds
        tm, lm = ocr.detector_scores(canv)
        rs, ls = tm.flatten()[:: 97].float(), lm.flatten()[:: 97].float()
        e2e_cfg = cfg.replace(low_text=q(rs, 0.80).item(), text_threshold=q(rs, 0.95).item(),
                              link_threshold=q(ls, 0.97).item())
        args = ocr.prepare(imgs, cb, gb)
    del ocr, y_lo, t, ya, got, ref, canv, tm, lm
    plan_launches = plan_dispatches(e2e_cfg, det_sd, rec_sd, args)
    del args
    log(f"phase plans: {time.perf_counter() - t0:.2f} s")

    # -- phase 6: end to end through the server: bf16 default, bf16 stem, int8 cpool2
    t0 = time.perf_counter()
    model, launches, rps, _ = serve(e2e_cfg, det_sd, rec_sd, imgs, BF16_DISPATCHES, "bf16 tail,s2d")
    for k in ("conv12_pool", "seam_tail", "cc"):
        assert launches[k] > 0, f"{k} not on the bf16 tail,s2d path: {launches}"
    # the seam tail runs once a dispatch, whatever batches the worker formed
    assert launches["conv12_pool"] == launches["seam_tail"], f"#5 not in every dispatch: {launches}"
    log(f"phase e2e bf16: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    stages = stage_times(model.ocr, imgs)
    log("stages ms (one b16 dispatch, bf16 tail,s2d): "
        + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    del model
    log(f"phase stages bf16: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    s_cfg = e2e_cfg.replace(fused_stages="tail,stem")
    model, s_launches, s_rps, _ = serve(s_cfg, det_sd, rec_sd, imgs, BF16_DISPATCHES, "bf16 tail,stem")
    for k in ("stem_conv", "seam_tail", "cc"):
        assert s_launches[k] == BF16_DISPATCHES, f"{k} not in every bf16 tail,stem dispatch: {s_launches}"
    log(f"phase e2e bf16 stem: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    stages = stage_times(model.ocr, imgs)
    log("stages ms (one b16 dispatch, bf16 tail,stem): "
        + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    del model
    log(f"phase stages bf16 stem: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    q_cfg = e2e_cfg.replace(quant_int8=True, fused_stages="tail,cpool2")
    model, q_launches, q_rps, _ = serve(q_cfg, det_sd, rec_sd, imgs, DISPATCHES, "int8 tail,cpool2")
    for k in ("conv12_pool_conv21_q", "seam_tail", "cc"):
        assert q_launches[k] > 0, f"{k} not on the int8 cpool2 path: {q_launches}"
    assert q_launches["conv12_pool_conv21_q"] == q_launches["seam_tail"], \
        f"#7 not in every dispatch: {q_launches}"
    log(f"e2e int8 tail,cpool2: {q_rps:.2f} receipts/s on {smi} (bf16 tail,s2d: {rps:.2f}, "
        f"bf16 tail,stem: {s_rps:.2f})")
    log(f"phase e2e int8: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    stages = stage_times(model.ocr, imgs)
    log("stages ms (one b16 dispatch, int8 tail,cpool2): "
        + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    del model
    log(f"phase stages int8: {time.perf_counter() - t0:.2f} s")

    # -- phase 8: the per-image engines from .pth files, card vs CPU --------
    t0 = time.perf_counter()
    engine_model = engines_phase(e2e_cfg, det_sd, rec_sd, imgs, smi)
    log(f"phase engines: {time.perf_counter() - t0:.2f} s")

    # -- phase 9: batched serving with the CTC head ---------------------------
    t0 = time.perf_counter()
    c_cfg = e2e_cfg.replace(prediction="CTC", transform="None")
    c_rec_sd = init_module(CRNNet(c_cfg), torch.Generator().manual_seed(SEED + 1)).state_dict()
    model, c_launches, c_rps, c_answers = serve(c_cfg, det_sd, c_rec_sd, imgs, CTC_DISPATCHES,
                                                "bf16 tail,s2d CTC")
    for k in ("conv12_pool", "seam_tail", "cc"):
        assert c_launches[k] == CTC_DISPATCHES, f"{k} not in every CTC dispatch: {c_launches}"
    assert model.recognizer.cfg.prediction == "CTC"
    assert all(isinstance(t, str) for a in c_answers for t in a)
    log(f"e2e bf16 tail,s2d CTC: {c_rps:.2f} receipts/s on {smi}")
    del model
    log(f"phase ctc_batched: {time.perf_counter() - t0:.2f} s")

    # -- phase 10: the HTTP front end ----------------------------------------
    t0 = time.perf_counter()
    http_phase(e2e_cfg, det_sd, rec_sd, imgs, engine_model, smi)
    del engine_model
    log(f"phase http: {time.perf_counter() - t0:.2f} s")

    # -- phases 11-12: beam decoding with an LM prior; the server's CLI ------
    lm_dir = tempfile.mkdtemp(prefix="lightly_ocr_lm_")
    try:
        # a charset-space [n+1, n+1] log-prior from the seed (rows are
        # log-probabilities, weight 0.4), as scripts/build_lm_prior.py writes one
        prior_path = os.path.join(lm_dir, "prior.npy")
        n = len(e2e_cfg.character)
        rows = np.random.default_rng(SEED).dirichlet(np.ones(n + 1), size=n + 1)
        np.save(prior_path, (0.4 * np.log(rows)).astype(np.float32))
        t0 = time.perf_counter()
        beam_phase(e2e_cfg, det_sd, rec_sd, c_rec_sd, imgs, prior_path,
                   {"attention": rps, "ctc": c_rps}, smi)
        log(f"phase beam: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        cli_phase(prior_path, encode_png(imgs[0]), smi)
        log(f"phase cli: {time.perf_counter() - t0:.2f} s")
    finally:
        shutil.rmtree(lm_dir, ignore_errors=True)

    # -- phase 13: CRNN training on the card --------------------------------
    t0 = time.perf_counter()
    train_phase(smi)
    log(f"phase train: {time.perf_counter() - t0:.2f} s")

    # -- phase 14: CRAFT detector training on the card ------------------------
    t0 = time.perf_counter()
    craft_phase(smi)
    log(f"phase craft: {time.perf_counter() - t0:.2f} s")

    # launches: each kernel's count over the timed run of the path that
    # drives it (the bf16 default plan for the seam tail, CC and #5, the bf16
    # stem plan for #4, the int8 cpool2 plan for #7, one dispatch of bf16
    # cpool2 / SEAMK=0 for #6 / #3)
    paths = {"seam_tail": ("bf16 tail,s2d", launches), "cc": ("bf16 tail,s2d", launches),
             "tail": ("bf16 tail,s2d SEAMK=0", plan_launches["bf16 tail,s2d SEAMK=0"]),
             "stem_conv": ("bf16 tail,stem", s_launches),
             "conv12_pool": ("bf16 tail,s2d", launches),
             "conv12_pool_conv21": ("bf16 tail,cpool2", plan_launches["bf16 tail,cpool2"]),
             "conv12_pool_conv21_q": ("int8 tail,cpool2", q_launches)}
    kernels = [
        {"name": "seam_tail", "route": "cuda",
         "source": "lightly_ocr_tpu_torch/csrc/seam_tail.cu",
         "replaces": "lightly_ocr_tpu/ops/pallas_tail.py:258",
         "max_abs_err": tail_err,
         "ms": tail_ms, "plain_ms": tail_plain_ms, "bound_ms": tail_bound,
         "bound_by": tail_by, "library_ms": tail_lib_ms},
        {"name": "connected_components", "route": "cuda",
         "source": "lightly_ocr_tpu_torch/csrc/cc.cu",
         "replaces": "lightly_ocr_tpu/ops/pallas_cc.py:28",
         "max_abs_err": cc_err,
         "ms": cc_ms, "plain_ms": cc_plain_ms, "bound_ms": cc_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "tail_chain", "route": "cuda",
         "source": "lightly_ocr_tpu_torch/csrc/seam_tail.cu",
         "replaces": "lightly_ocr_tpu/ops/pallas_tail.py:166",
         "max_abs_err": chain_err,
         "ms": chain_ms, "plain_ms": chain_plain_ms, "bound_ms": chain_bound,
         "bound_by": chain_by, "library_ms": chain_lib_ms},
        *stem_lines.values(),
    ]
    for k, key in zip(kernels, paths):
        path, counts = paths[key]
        k["launches"], k["path"] = counts[key], path
    log(f"total wall: {time.perf_counter() - t_all:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
