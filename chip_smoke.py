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
7. a per-stage breakdown of one dispatch of each of the three served plans.

Then one JSON line with each kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  TF32 is switched OFF for float32 matmuls
and convolutions (``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), so the plain versions
accumulate in full float32.  Without a CUDA device the script exits 2 and
prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

BATCH, BOXES = 16, 32
RECEIPT_H, RECEIPT_W = 600, 400
DISPATCHES = 5  # timed dispatches of the int8 cpool2 plan
BF16_DISPATCHES = 3  # timed dispatches of the bf16 default plan
SEED = 0
# H100 SXM data-sheet peaks (dense): bf16 and int8 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    from lightly_ocr_tpu_torch.config import Config
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
