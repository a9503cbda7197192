"""Curved-text polygon refinement (the ``enable_poly`` detector mode).

The port's own copy of ``lightly_ocr_tpu/ops/poly.py`` (numpy only, so it
runs the same on either side); behavioural counterpart of the reference's
polygon post-pass (``ocr/tools/det_utils.py:97-245``).  Given a word's
min-area rectangle and the compact component-id map of
:func:`lightly_ocr_tpu_torch.ops.detection.get_det_boxes` (``return_cid``),
it decides whether the word is curved enough to deserve a 14-point polygon
hugging the text line, and builds one.

The rectified component is analysed as whole-array column statistics (top
and bottom envelope, thickness); strips are assigned with a closed-form
saturating counter, and pivots are a grouped argmax.  No cv2: the 4-point
homography is an 8x8 linear solve, rectification an inverse-mapped nearest
gather, and the clearance test samples the segment densely.

Pipeline per box (the reference's thresholds):
  rectify -> column envelope -> reject straight/short words -> split the
  width into 11 strips -> per odd strip, pivot at the thickest column ->
  perpendicular cross-bars of length 1.45 * median thickness -> extend the
  first/last bars outward until they clear the component -> unwarp.

Known deviation (as in the JAX package; not output-visible on contiguous
words): the reference averages a strip's centroid only when its column scan
crosses a strip boundary; here every strip is averaged.
"""
from __future__ import annotations

import math

import numpy as np

# Reference thresholds (det_utils.py:99-103).
PIVOTS = 5  # pivot count -> 2*PIVOTS+1 strips
STRAIGHT_RATIO = 0.7  # reject if thickness ~ box height
THICKNESS_GAIN = 1.45  # cross-bar length / median thickness
REACH_LIMIT = 2.0  # outward search range (in bar lengths)
REACH_STEP = 0.2


def perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3x3 homography mapping 4 src points onto 4 dst points
    (cv2.getPerspectiveTransform equivalent, direct 8x8 solve)."""
    A, b = [], []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b += [u, v]
    h = np.linalg.solve(np.asarray(A, np.float64), np.asarray(b, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def warp_nearest(labels: np.ndarray, M: np.ndarray, w: int, h: int) -> np.ndarray:
    """Inverse-map nearest warp of an int label image to (h, w)."""
    Minv = np.linalg.inv(M)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    ones = np.ones_like(xs)
    pts = np.stack([xs, ys, ones], axis=0).reshape(3, -1)
    src = Minv @ pts
    sx = np.round(src[0] / src[2]).astype(np.int64)
    sy = np.round(src[1] / src[2]).astype(np.int64)
    ok = (sx >= 0) & (sx < labels.shape[1]) & (sy >= 0) & (sy < labels.shape[0])
    out = np.zeros(h * w, labels.dtype)
    out[ok.reshape(-1)] = labels[sy.reshape(-1)[ok.reshape(-1)],
                                 sx.reshape(-1)[ok.reshape(-1)]]
    return out.reshape(h, w)


def _unwarp(Minv: np.ndarray, xy) -> np.ndarray:
    v = Minv @ np.asarray([xy[0], xy[1], 1.0])
    return np.asarray([v[0] / v[2], v[1] / v[2]])


def _column_envelope(mask: np.ndarray):
    """Per-column top/bottom y of a bool mask, restricted to columns with
    >= 2 set pixels.  Vectorized: top = argmax down, bottom = argmax up.

    Returns (xs, top, bottom) as int arrays over the kept columns, in x
    order.
    """
    counts = mask.sum(axis=0)
    keep = counts >= 2
    xs = np.flatnonzero(keep)
    if xs.size == 0:
        return xs, xs, xs
    sub = mask[:, xs]
    top = sub.argmax(axis=0)
    bottom = mask.shape[0] - 1 - sub[::-1].argmax(axis=0)
    return xs, top, bottom


def _strip_of(xs: np.ndarray, strip_w: float, n_strips: int) -> np.ndarray:
    """Strip index per column under the reference's scan semantics.

    The reference walks populated columns left to right and advances its
    strip counter AT MOST ONCE per column, so after a gap spanning
    multiple strips the attribution lags behind the geometric strip.  The
    closed form of that saturating counter is
    ``strip[j] = min_{k<=j} (geom[k] + (j - k))`` — a running minimum of
    ``geom - index``.
    """
    geom = np.minimum((xs / strip_w).astype(np.int64), n_strips - 1)
    j = np.arange(xs.size)
    return np.minimum(geom, np.minimum.accumulate(geom - j) + j)


def refine_polygon(box: np.ndarray, labels: np.ndarray,
                   component_id: int) -> np.ndarray | None:
    """One box -> refined polygon [14, 2] or None (keep the rectangle)."""
    w = int(np.linalg.norm(box[0] - box[1]) + 1)
    h = int(np.linalg.norm(box[1] - box[2]) + 1)
    if w < 10 or h < 10:
        return None

    upright = np.asarray([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    try:
        M = perspective_transform(np.asarray(box, np.float64), upright)
        Minv = np.linalg.inv(M)
    except np.linalg.LinAlgError:
        return None
    patch = warp_nearest(labels, M, w, h) == component_id

    xs, top, bottom = _column_envelope(patch)
    if xs.size == 0:
        return None
    thickness = bottom - top + 1
    if thickness.max() > h * STRAIGHT_RATIO:
        return None

    n_strips = 2 * PIVOTS + 1
    strip_w = w / n_strips
    # The reference bails out when the first populated column already lies
    # beyond strip 0 (its accumulator is empty at the first crossing).
    if xs[0] >= strip_w:
        return None
    strip = _strip_of(xs, strip_w, n_strips)
    center = (top + bottom) * 0.5

    # per-strip centroids of (x, center) — used as direction anchors
    anchor = np.zeros((n_strips, 2))
    filled = np.zeros(n_strips, bool)
    for s in range(n_strips):
        in_s = strip == s
        if in_s.any():
            anchor[s] = (xs[in_s].mean(), center[in_s].mean())
            filled[s] = True

    # pivots: per odd strip, the first thickest column
    pivot_xy = np.zeros((PIVOTS, 2))
    pivot_thick = np.zeros(PIVOTS)
    for i in range(PIVOTS):
        in_s = strip == 2 * i + 1
        if not in_s.any():
            return None
        k = np.flatnonzero(in_s)[np.argmax(thickness[strip == 2 * i + 1])]
        pivot_xy[i] = (xs[k], center[k])
        pivot_thick[i] = thickness[k]
    if strip_w < pivot_thick.max() * 0.25:
        return None

    bar_half = float(np.median(pivot_thick)) * THICKNESS_GAIN / 2.0

    # cross-bars: perpendicular to the local text direction, estimated
    # from the even-strip anchors flanking each pivot
    bars = np.zeros((PIVOTS, 4))  # (x_top, y_top, x_bot, y_bot)
    for i in range(PIVOTS):
        x, cy = pivot_xy[i]
        dxy = anchor[2 * i + 2] - anchor[2 * i]
        if dxy[0] == 0:
            bars[i] = (x, cy - bar_half, x, cy + bar_half)
        else:
            ang = -math.atan2(dxy[1], dxy[0])
            c, s = bar_half * math.cos(ang), bar_half * math.sin(ang)
            bars[i] = (x - s, cy - c, x + s, cy + c)

    # outward extension of the first/last bars until they clear the label
    slope_head = _chord_slope(pivot_xy[1], pivot_xy[0]) + _chord_slope(
        pivot_xy[2], pivot_xy[1]
    )
    slope_tail = _chord_slope(pivot_xy[-2], pivot_xy[-1]) + _chord_slope(
        pivot_xy[-3], pivot_xy[-2]
    )
    head = tail = None
    for r in np.arange(0.5, REACH_LIMIT, REACH_STEP):
        reach = 2.0 * bar_half * r
        forced = r + 2 * REACH_STEP >= REACH_LIMIT
        if head is None:
            cand = bars[0] - np.asarray(
                [reach, slope_head * reach, reach, slope_head * reach]
            )
            if forced or not _bar_touches(patch, cand):
                head = cand
        if tail is None:
            cand = bars[-1] + np.asarray(
                [reach, slope_tail * reach, reach, slope_tail * reach]
            )
            if forced or not _bar_touches(patch, cand):
                tail = cand
        if head is not None and tail is not None:
            break
    if head is None or tail is None:
        return None

    ring = [_unwarp(Minv, head[:2])]
    ring += [_unwarp(Minv, b[:2]) for b in bars]
    ring += [_unwarp(Minv, tail[:2]), _unwarp(Minv, tail[2:])]
    ring += [_unwarp(Minv, b[2:]) for b in bars[::-1]]
    ring.append(_unwarp(Minv, head[2:]))
    return np.asarray(ring)


def _chord_slope(a, b) -> float:
    return (a[1] - b[1]) / (a[0] - b[0])


def _bar_touches(patch: np.ndarray, bar) -> bool:
    """Does the segment (bar[0],bar[1])-(bar[2],bar[3]) cross the
    component?  Dense float sampling in place of the reference's
    rasterize-and-AND (det_utils.py:208-222)."""
    n = int(max(abs(bar[2] - bar[0]), abs(bar[3] - bar[1]))) * 2 + 2
    px = np.round(np.linspace(bar[0], bar[2], n)).astype(np.int64)
    py = np.round(np.linspace(bar[1], bar[3], n)).astype(np.int64)
    ok = (px >= 0) & (px < patch.shape[1]) & (py >= 0) & (py < patch.shape[0])
    if not ok.any():
        return False
    return bool(patch[py[ok], px[ok]].any())


def refine_polygons(boxes: np.ndarray, valid: np.ndarray,
                    labels: np.ndarray, cid: np.ndarray) -> list:
    """Batch helper over DetBoxes outputs: list of polygon|None per valid
    box (None = keep the rectangle, as the reference does)."""
    out = []
    cid_map = np.asarray(cid)
    for k in np.nonzero(np.asarray(valid))[0]:
        # the component's value in the compact-id map is k itself
        out.append(refine_polygon(np.asarray(boxes)[k], cid_map, int(k)))
    return out
