"""CRAFT score maps -> word boxes, batched (port of ``get_det_boxes``).

Port of ``lightly_ocr_tpu/ops/detection.py::get_det_boxes`` (reference
``ocr/tools/det_utils.py:35-94``), vectorised over the batch:

* candidates are component ROOTS (``label == linear index``), at most J=32
  leftmost per row when the map is tall enough, then the 2*``max_boxes``
  smallest root indices in ascending (scan) order;
* per-(candidate, row) statistics: pixel count, text peak, extreme columns
  of all pixels and of the geometry pixels (link-only pixels dropped);
* filter (area >= 10 and a pixel >= ``text_threshold``), compact the
  survivors to ``max_boxes`` slots in scan order;
* ``niter`` dilation applied in support space, the D=128 angle sweep for
  the minimum-area rectangle, the near-square axis-aligned case, clipping
  and the clockwise roll from the corner of least x + y.

The JAX version reduces the statistics with dense masked passes (TPU
scatters are slow); here they are ``scatter_reduce`` over (image,
candidate, row) bins, which gives the same values.
"""
from __future__ import annotations

import math

import torch

from lightly_ocr_tpu_torch.utils.profiling import SYNC, annotate

_BIG = 2**30
_INF = 1e30


def get_det_boxes(
    textmap: torch.Tensor,
    linkmap: torch.Tensor,
    labels: torch.Tensor,
    text_threshold: float = 0.7,
    link_threshold: float = 0.4,
    low_text: float = 0.4,
    max_boxes: int = 256,
    num_angles: int = 128,
    return_cid: bool = False,
):
    """[B, H, W] region/affinity maps + CC labels (min linear index per
    component, background H*W) -> (boxes [B, K, 4, 2] (x, y) heatmap
    corners clockwise, valid [B, K] bool).

    ``return_cid`` adds a third output, the JAX ``DetBoxes.cid``: [B, H, W]
    int64, each pixel's box slot in ``[0, K)``, ``K`` where its component
    has no box (poly mode reads it)."""
    B, H, W = textmap.shape
    HW, K, dev = H * W, max_boxes, textmap.device
    K2 = 2 * K
    f32 = torch.float32

    text = textmap > low_text
    link = linkmap > link_threshold
    fg = text | link
    lab = torch.where(fg, labels.long(), HW).view(B, HW)
    lin = torch.arange(HW, device=dev)
    roots = lab == lin  # [B, HW]

    J = min(32, W)
    if H >= 64 and K2 * 4 <= J * H:
        r3 = roots.view(B, H, W)
        roots = (r3 & (torch.cumsum(r3, dim=-1) <= J)).view(B, HW)
    rootv = torch.where(roots, lin, _BIG)
    k_take = min(K2, HW)
    cand = torch.topk(rootv, k_take, dim=1, largest=False, sorted=True).values
    if k_take < K2:
        cand = torch.cat([cand, torch.full((B, K2 - k_take), _BIG, device=dev, dtype=cand.dtype)], 1)
    cand_valid = cand < _BIG

    # pixel -> candidate slot (K2 = none), then (image, slot, row) bins
    cid = torch.searchsorted(cand, lab).clamp_(max=K2 - 1)
    matched = torch.gather(cand, 1, cid) == lab
    rows = (lin // W).expand(B, HW)
    cols = (lin % W).to(f32).expand(B, HW)
    bins = (torch.arange(B, device=dev)[:, None] * K2 + cid) * H + rows
    geom = matched & ~(link & ~text).view(B, HW)
    nb = B * K2 * H

    def reduce(mask, src, how, init):
        out = torch.full((nb,), init, dtype=f32, device=dev)
        with annotate(SYNC):  # a boolean mask's index waits for the card
            index = bins[mask]
        with annotate(SYNC):
            values = src[mask]
        out.scatter_reduce_(0, index, values, how, include_self=True)
        return out.view(B, K2, H)

    hot_src = (textmap >= text_threshold).to(f32).view(B, HW)
    cnt = reduce(matched, torch.ones_like(cols), "sum", 0.0)
    hot = reduce(matched, hot_src, "amax", 0.0)
    an = reduce(matched, cols, "amin", _INF)
    ax = reduce(matched, cols, "amax", -_INF)
    lx2 = reduce(geom, cols, "amin", _INF)
    rx2 = reduce(geom, cols, "amax", -_INF)

    area = cnt.sum(-1)
    peak_ok = hot.amax(-1) > 0.5
    maxx = ax.amax(-1)
    minx = an.amin(-1)
    rows_f = torch.arange(H, device=dev, dtype=f32)
    maxy = torch.where(cnt > 0, rows_f, -_INF).amax(-1)
    miny = (cand // W).to(f32)  # root = topmost-leftmost pixel

    keep = cand_valid & (area >= 10) & peak_ok
    rank = torch.cumsum(keep, dim=1) - 1
    slot = torch.where(keep & (rank < K), rank, K)
    sel = torch.full((B, K + 1), K2, dtype=torch.long, device=dev)
    sel.scatter_(1, slot, torch.arange(K2, device=dev).expand(B, K2))
    sel = sel[:, :K]
    valid = sel < K2
    sel_c = sel.clamp(max=K2 - 1)

    def pick(a):
        return torch.gather(a, 1, sel_c)

    k_area = torch.where(valid, pick(area), 0.0)
    k_w = torch.where(valid, pick(maxx) - pick(minx) + 1.0, 1.0)
    k_h = torch.where(valid, pick(maxy) - pick(miny) + 1.0, 1.0)
    # niter = floor(sqrt(size * min(w,h) / (w*h)) * 2)   (det_utils.py:63)
    niter = torch.floor(
        torch.sqrt(k_area * torch.minimum(k_w, k_h) / torch.clamp(k_w * k_h, min=1.0)) * 2.0
    )
    he = niter / 2.0  # Minkowski half-extent of the (1 + niter) box kernel
    shift = torch.where(torch.fmod(niter, 2.0) == 1.0, 0.5, 0.0)

    idx3 = sel_c[:, :, None].expand(B, K, H)
    lx = torch.where(valid[..., None], torch.gather(lx2, 1, idx3), _INF)
    rx = torch.where(valid[..., None], torch.gather(rx2, 1, idx3), -_INF)
    row_has = rx > -1e29
    yv = rows_f.view(1, 1, H, 1)
    lx_ = torch.where(row_has, lx, 0.0)[..., None]  # [B, K, H, 1]
    rx_ = torch.where(row_has, rx, 0.0)[..., None]
    neg = torch.where(row_has, 0.0, _INF)[..., None]
    pos = torch.where(row_has, 0.0, -_INF)[..., None]

    # dense support sweep over D angles in [0, 90)
    theta = torch.arange(num_angles, device=dev, dtype=f32) * (math.pi / 2.0 / num_angles)
    c, s = torch.cos(theta), torch.sin(theta)
    ux_min = (lx_ * c + yv * s + neg).amin(2)  # [B, K, D]
    ux_max = (rx_ * c + yv * s + pos).amax(2)
    uy_min = (-rx_ * s + yv * c + neg).amin(2)
    uy_max = (-lx_ * s + yv * c + pos).amax(2)

    grow = he[..., None] * (c.abs() + s.abs())
    shift_x = shift[..., None] * (c + s)
    shift_y = shift[..., None] * (c - s)
    x0 = ux_min - grow + shift_x
    x1 = ux_max + grow + shift_x
    y0 = uy_min - grow + shift_y
    y1 = uy_max + grow + shift_y
    areas = (x1 - x0) * (y1 - y0)
    areas = torch.where(torch.isfinite(areas), areas, math.inf)
    best = torch.argmin(areas, dim=2, keepdim=True)  # [B, K, 1]

    def at_best(a):
        return torch.gather(a, 2, best)[..., 0]

    bx0, bx1, by0, by1 = at_best(x0), at_best(x1), at_best(y0), at_best(y1)
    bc, bs = c[best[..., 0]], s[best[..., 0]]
    u_vec = torch.stack([bc, bs], -1)  # [B, K, 2]
    v_vec = torch.stack([-bs, bc], -1)
    cx = torch.stack([bx0, bx1, bx1, bx0], -1)  # [B, K, 4]
    cy = torch.stack([by0, by0, by1, by1], -1)
    corners = cx[..., None] * u_vec[:, :, None, :] + cy[..., None] * v_vec[:, :, None, :]

    # square-box case (det_utils.py:79-84): axis-aligned box of the dilation
    side_w, side_h = bx1 - bx0, by1 - by0
    ratio = torch.maximum(side_w, side_h) / (torch.minimum(side_w, side_h) + 1e-5)
    is_square = (1.0 - ratio).abs() <= 0.1
    g_minx = ux_min[..., 0] - he + shift
    g_maxx = ux_max[..., 0] + he + shift
    g_miny = uy_min[..., 0] - he + shift
    g_maxy = uy_max[..., 0] + he + shift
    sq = torch.stack([
        torch.stack([g_minx, g_miny], -1),
        torch.stack([g_maxx, g_miny], -1),
        torch.stack([g_maxx, g_maxy], -1),
        torch.stack([g_minx, g_maxy], -1),
    ], 2)  # [B, K, 4, 2]
    corners = torch.where(is_square[..., None, None], sq, corners)
    corners = torch.stack([
        corners[..., 0].clamp(0.0, W - 1.0),
        corners[..., 1].clamp(0.0, H - 1.0),
    ], -1)

    # clockwise order from the corner with the least x + y (det_utils.py:87-88)
    start = torch.argmin(corners.sum(-1), dim=2, keepdim=True)  # [B, K, 1]
    roll = (torch.arange(4, device=dev) + start) % 4
    corners = torch.gather(corners, 2, roll[..., None].expand(B, K, 4, 2))
    corners = torch.where(valid[..., None, None], corners, 0.0)
    if not return_cid:
        return corners, valid
    cid_px = torch.where(matched, torch.gather(slot, 1, cid), K).view(B, H, W)
    return corners, valid, cid_px


def boxes_to_rects(boxes: torch.Tensor, valid: torch.Tensor,
                   ratio_w: float, ratio_h: float) -> torch.Tensor:
    """Boxes [K, 4, 2] -> axis-aligned int32 rects [K, 4] (row0, col0,
    row1, col1) in original-image coordinates: corners scaled by the x2 net
    ratio and ``ratio_w``/``ratio_h`` in float32, truncated to int, then
    min/max per axis (``det_utils.py:259-265``, ``net.py:93-97``); invalid
    rows are 0."""
    scale = torch.tensor([ratio_w * 2.0, ratio_h * 2.0], dtype=torch.float32,
                         device=boxes.device)
    as_int = (boxes.float() * scale).to(torch.int32)
    x0, y0 = as_int[..., 0].amin(1), as_int[..., 1].amin(1)
    x1, y1 = as_int[..., 0].amax(1), as_int[..., 1].amax(1)
    rects = torch.stack([y0, x0, y1, x1], 1)
    return torch.where(valid[:, None], rects, 0)
