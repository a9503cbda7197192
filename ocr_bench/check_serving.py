"""The serving check: what the timed window served, against the plain
reference, on the receipts of the dispatches the glue kept.

Numbers (each against its limit in ``limits/<cell>.json``):

* ``map_err``: the widest gap between the program's region or affinity
  score and the reference's float32 score on the same receipt, over the
  largest reference score (the detector: canvas, VGG16-BN U-Net, the fused
  kernels of the serving plan);
* ``box_mismatch``: the box stage followed from the program's own maps:
  the reference's boxes from the program's score maps against the
  program's served rects, in order: rects missing on either side, and
  rects more than a pixel from every box of the reference's tied angles
  (``reference.boxes.det_boxes(ties=True)``: the reference sweeps in
  float64, the program in float32, and a small component's symmetric
  pixels give two angles one area), counted; limit 0 (connected
  components, box extraction, the mapping to the image).  The detector, the stage before it, is
  ``map_err``'s: bf16 maps thresholded split or merge a few components
  against float32 ones, so boxes from the two kinds of maps differ on
  sound runs by as much as under the control;
* ``logit_err``: the program's logits against the reference's at every
  served decode step (each served box's steps up to and including its
  first end token), the reference fed the program's tokens on its own
  crops of the program's rects: for each box the root mean square of the
  gap over that of the reference's logits, and of those the median
  (crops, TPS, ResNet, BiLSTM, attention).  A median passes a fault in
  fewer than half of the boxes; ``logit_gap_rel`` holds every box's
  tokens.  Also read, with no limit: the 90th percentile and the largest
  of the same (``logit_crop_p90``, ``logit_crop_max``), the same over all
  boxes at once (``logit_rms_err``) and the widest single gap over the
  largest logit (``logit_max_err``): a few sensitive boxes of some seeds
  raise them, and none kept three times between the sound runs and the
  control;
* ``logit_gap_rel``: the served tokens themselves, on every box: at each
  served step the gap by which the reference's logit of the served token
  lies below its best, over the spread of the reference's logits at that
  step (best minus worst), the widest (the decode loop: a token chosen
  wrong, emitted and fed back, reads up to 1);
* ``text_mismatch``: served texts that differ from the decode of the
  program's own tokens (end token stops, [GO] skipped): an exact check of
  the host decode, limit 0.

Also read, with no limit: ``logit_gap``, the same gap in logits (random
weights put the two best classes of many steps closer together than the
bfloat16 program's own rounding moves them, so a runner-up chosen in their
place reads no more than sound runs do), and ``box_miss``, the share of
the boxes from the program's maps and from the reference's that find no
partner of IoU 0.5 in the other list (sound runs read up to 0.24, the
control from 0.67).

The control computes the reference in float8 (e4m3 products) in the
program's place and reads the same numbers against the float32 reference:
its maps, its boxes, its logits on the same crops and tokens.
"""
from __future__ import annotations

import numpy as np
import torch

from ocr_bench.reference import boxes as rboxes
from ocr_bench.reference import craft, crnn, prep
from ocr_bench.reference.common import FP32, Precision, float32_exact

EOS, GO = 1, 0
CHUNK = 4  # receipts a detector call of the reference


def served_steps(idx: torch.Tensor) -> torch.Tensor:
    """[n, T] tokens -> [n, T] bool: the steps up to and including the
    first end token (all T where none)."""
    eos = idx == EOS
    before = torch.cumsum(eos.int(), 1) - eos.int() == 0
    return before


def decode_text(row, charset: str) -> str:
    out = []
    for t in row:
        t = int(t)
        if t == EOS:
            break
        if t != GO:
            out.append(charset[t - 2])
    return "".join(out)


def reference_maps(det_sd, pool, pids, cfgd, p: Precision):
    """[(region, affinity) float32 numpy, ratio] of each receipt."""
    out = []
    dev = next(iter(det_sd.values())).device
    for i in range(0, len(pids), CHUNK):
        canv, ratios = zip(*(prep.detector_canvas(pool[j], cfgd, dev) for j in pids[i:i + CHUNK]))
        with torch.no_grad():
            maps = craft.forward(det_sd, torch.stack(canv), p)
        out += [(m[..., 0].cpu().numpy(), m[..., 1].cpu().numpy(), r) for m, r in zip(maps, ratios)]
    return out


def check(*args, **kw) -> dict:
    with float32_exact():
        return _check(*args, **kw)


def _check(captured: list, pool: list, det_sd: dict, rec_sd: dict, cfgd: dict, rcfg: dict,
          control: bool = False) -> dict:
    """{number: value} of the program (or, with ``control``, of the float8
    reference in its place) on the captured dispatches."""
    dev = next(iter(det_sd.values())).device
    thr = (cfgd["text_threshold"], cfgd["link_threshold"], cfgd["low_text"])
    K = int(cfgd["boxes_per_image"])
    low = Precision("fp8")
    map_err, miss, total, mismatch, box_mismatch = 0.0, 0, 0, 0, 0
    box_detail = []
    crops, fed, served, got_logits = [], [], [], []
    rnet = crnn.CRNN(rec_sd, rcfg, FP32)
    for cap in captured:
        pids = cap["pids"]
        ref = reference_maps(det_sd, pool, pids, cfgd, FP32)
        got = reference_maps(det_sd, pool, pids, cfgd, low) if control else None
        out = {k: v.detach() for k, v in cap["out"].items()}
        for j, pid in enumerate(pids):
            region, link, ratio = ref[j]
            if control:
                g_region, g_link = got[j][0], got[j][1]
            else:
                g_region = cap["maps"][0][j].float().cpu().numpy()
                g_link = cap["maps"][1][j].float().cpu().numpy()
            scale = max(np.abs(region).max(), np.abs(link).max(), 1e-12)
            map_err = max(map_err, float(max(np.abs(g_region - region).max(),
                                             np.abs(g_link - link).max()) / scale))
            h, w = pool[pid].shape[:2]
            ref_rects = rboxes.rects(rboxes.det_boxes(region, link, *thr, K), ratio, h, w)
            if control:
                got_rects = rboxes.rects(rboxes.det_boxes(g_region, g_link, *thr, K), ratio, h, w)
            else:
                got_rects = [tuple(it["rect"]) for it in cap["results"][j]]
            miss += rboxes.unmatched(got_rects, ref_rects)
            total += len(got_rects) + len(ref_rects)
            if not control:
                own = [[r for r in (rboxes.rect(c, ratio, h, w) for c in tied) if r is not None]
                       for tied in rboxes.det_boxes(g_region, g_link, *thr, K, ties=True)]
                own = [t for t in own if t]
                off = [(t, b) for t, b in zip(own, got_rects)
                       if min(max(abs(x - y) for x, y in zip(a, b)) for a in t) > 1.0]
                box_mismatch += abs(len(own) - len(got_rects)) + len(off)
                if off or len(own) != len(got_rects):
                    box_detail.append({"receipt": int(pid), "n": [len(own), len(got_rects)],
                                       "pairs": [[t, list(b)] for t, b in off]})
            valid = out["valid"][j]
            idx = out["pred_idx"][j][valid]
            texts = [it["text"] for it in cap["results"][j]]
            if not control:
                mismatch += sum(t != decode_text(r, cfgd["character"]) for t, r in zip(texts, idx.tolist()))
                mismatch += abs(len(texts) - len(idx))
            gray = prep.gray(pool[pid], dev)
            for r in out["rects"][j][valid].tolist():
                crops.append(prep.crop(gray, r, rcfg["height"], rcfg["width"]))
            fed.append(torch.cat([torch.zeros_like(idx[:, :1]), idx[:, :-1]], 1))
            served.append(idx)
            if not control:
                lg = cap["logits"].detach().float()
                got_logits.append(lg.view(len(out["valid"]), -1, *lg.shape[1:])[j][valid])
    gap, gap_rel, err, max_err, crop_med, crop_p90, crop_max, n_steps = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0
    if crops:
        crops, fed, prog = torch.stack(crops), torch.cat(fed), torch.cat(served)
        mask = served_steps(prog)
        with torch.no_grad():
            logits = rnet.forced_logits(crops, fed)
            got = crnn.CRNN(rec_sd, rcfg, low).forced_logits(crops, fed) if control else torch.cat(got_logits)
        tok = got.argmax(-1) if control else prog
        gaps = logits.max(-1).values - logits.gather(-1, tok[..., None])[..., 0]
        gap = float(torch.where(mask, gaps, 0.0).max())
        spread = logits.max(-1).values - logits.min(-1).values
        gap_rel = float(torch.where(mask, gaps / spread.clamp_min(1e-30), 0.0).max())
        d, r = (got - logits)[mask], logits[mask]
        err = float(d.square().mean().sqrt() / r.square().mean().sqrt())
        max_err = float(d.abs().max() / r.abs().max())
        m = mask[..., None].float()
        per_crop = (((got - logits) ** 2 * m).sum((1, 2)) / ((logits ** 2) * m).sum((1, 2))).sqrt()
        crop_med, crop_p90 = (float(v) for v in torch.quantile(per_crop, torch.tensor([0.5, 0.9], device=per_crop.device)))
        crop_max = float(per_crop.max())
        n_steps = int(mask.sum())
    nums = {"map_err": map_err, "logit_err": crop_med, "logit_crop_p90": crop_p90, "logit_crop_max": crop_max,
            "logit_rms_err": err,
            "logit_max_err": max_err, "logit_gap": gap, "logit_gap_rel": gap_rel,
            "box_miss": miss / max(total, 1)}
    if not control:
        nums["text_mismatch"] = float(mismatch)
        nums["box_mismatch"] = float(box_mismatch)
        nums["box_mismatch_detail"] = box_detail[:4]
    nums["served_steps"] = n_steps
    return nums
