"""Word boxes from CRAFT's score maps, one image at a time in numpy
(CRAFT-pytorch ``getDetBoxes_core``), with the serving system's stated
bounds on the work:

* the foreground is ``region > low_text or affinity > link_threshold``;
  its 4-connected components are taken in the scan order of their first
  pixel, at most 32 first pixels a row (on a map of 64 rows or more) and the
  first ``2 * max_boxes`` in all; those of at least 10 pixels that reach
  ``text_threshold`` somewhere are kept, the first ``max_boxes`` of them;
* each kept component without its affinity-only pixels is dilated by a
  square of side ``1 + niter``, ``niter = int(sqrt(size * min(w, h) / (w *
  h)) * 2)`` (cv2's anchor: half a pixel further right and down where the
  side is even), and boxed by the least-area rectangle over 128 angles in
  [0, 90) degrees (cv2's ``minAreaRect`` is exact; the system sweeps);
  a box within 10% of square becomes the axis-aligned box of the dilation;
  corners are clipped to the map and start from the least x + y;
* the corners are scaled by 2 / the resize ratio, truncated, and their
  extremes clipped to the image: (row0, col0, row1, col1); a box of no
  area is dropped.
"""
from __future__ import annotations

import math

import numpy as np
from scipy import ndimage

ANGLES = 128
TIE = 1e-4  # areas this close to the least are a tie of angles


def det_boxes(text: np.ndarray, link: np.ndarray, text_threshold: float, link_threshold: float,
              low_text: float, max_boxes: int, ties: bool = False) -> list:
    """[H, W] region and affinity -> [4 x 2 corners (x, y), clockwise].

    With ``ties``, each box is the list of the boxes of every angle whose
    area is within ``TIE`` of the least: a small component's pixels are
    often symmetric, so two angles give one area, and which of them a
    float32 sweep picks is rounding."""
    H, W = text.shape
    is_text = text > low_text
    is_link = link > link_threshold
    labels, n = ndimage.label(is_text | is_link)  # 4-connectivity
    if n == 0:
        return []
    flat = labels.ravel()
    first = ndimage.minimum(np.arange(H * W).reshape(H, W), labels, np.arange(1, n + 1)).astype(np.int64)
    order = np.argsort(first)
    first = first[order]
    if H >= 64 and 2 * max_boxes * 4 <= min(32, W) * H:
        rows = first // W
        rank = np.zeros(len(first), np.int64)
        for r in np.unique(rows):
            sel = np.nonzero(rows == r)[0]
            rank[sel] = np.arange(len(sel))
        keep = rank < min(32, W)
        order, first = order[keep], first[keep]
    cands = order[: 2 * max_boxes] + 1  # labels in scan order of the first pixel
    geometry = ~(is_link & ~is_text)
    idx = np.arange(H * W)
    boxes = []
    theta = np.arange(ANGLES) * (math.pi / 2 / ANGLES)
    c, s = np.cos(theta), np.sin(theta)
    for lab in cands:
        pix = idx[flat == lab]
        if len(pix) < 10 or text.ravel()[pix].max() < text_threshold:
            continue
        ys, xs = pix // W, pix % W
        w = xs.max() - xs.min() + 1
        h = ys.max() - ys.min() + 1
        niter = math.floor(math.sqrt(len(pix) * min(w, h) / (w * h)) * 2)
        g = geometry.ravel()[pix]
        gx, gy = xs[g].astype(np.float64), ys[g].astype(np.float64)
        he = niter / 2.0
        shift = 0.5 if niter % 2 == 1 else 0.0
        u = gx[:, None] * c + gy[:, None] * s
        v = -gx[:, None] * s + gy[:, None] * c
        grow = he * (np.abs(c) + np.abs(s))
        x0 = u.min(0) - grow + shift * (c + s)
        x1 = u.max(0) + grow + shift * (c + s)
        y0 = v.min(0) - grow + shift * (c - s)
        y1 = v.max(0) + grow + shift * (c - s)
        area = (x1 - x0) * (y1 - y0)
        best = np.nonzero(area <= area.min() * (1.0 + TIE))[0] if ties else [int(np.argmin(area))]
        found = []
        for d in best:
            uv = np.array([[c[d], s[d]], [-s[d], c[d]]])
            corners = np.array([[x0[d], y0[d]], [x1[d], y0[d]], [x1[d], y1[d]], [x0[d], y1[d]]]) @ uv
            sw, sh = x1[d] - x0[d], y1[d] - y0[d]
            if abs(1.0 - max(sw, sh) / (min(sw, sh) + 1e-5)) <= 0.1:
                l, r = gx.min() - he + shift, gx.max() + he + shift
                t, b = gy.min() - he + shift, gy.max() + he + shift
                corners = np.array([[l, t], [r, t], [r, b], [l, b]])
            corners[:, 0] = corners[:, 0].clip(0.0, W - 1.0)
            corners[:, 1] = corners[:, 1].clip(0.0, H - 1.0)
            start = int(np.argmin(corners.sum(1)))
            found.append(np.roll(corners, -start, axis=0))
        boxes.append(found if ties else found[0])
        if len(boxes) == max_boxes:
            break
    return boxes


def rect(b: np.ndarray, ratio: float, h0: int, w0: int):
    """Heatmap corners -> (row0, col0, row1, col1) in image coordinates,
    or None for a rect of no area."""
    p = np.trunc(b.astype(np.float32) * (np.float32(2.0) * np.float32(1.0 / ratio)))
    c0, r0 = p.min(0)
    c1, r1 = p.max(0)
    r0, r1 = min(max(float(r0), 0.0), h0), min(max(float(r1), 0.0), h0)
    c0, c1 = min(max(float(c0), 0.0), w0), min(max(float(c1), 0.0), w0)
    return (r0, c0, r1, c1) if r1 > r0 and c1 > c0 else None


def rects(boxes: list, ratio: float, h0: int, w0: int) -> list:
    """Heatmap corners -> [(row0, col0, row1, col1)] in image coordinates."""
    return [r for r in (rect(b, ratio, h0, w0) for b in boxes) if r is not None]


def iou(a, b) -> float:
    r0, c0 = max(a[0], b[0]), max(a[1], b[1])
    r1, c1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(r1 - r0, 0.0) * max(c1 - c0, 0.0)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union > 0 else 0.0


def unmatched(got: list, ref: list, at: float = 0.5) -> int:
    """Boxes of either list with no partner of IoU >= ``at`` in the other
    (each box partners one box at most, best pairs first)."""
    pairs = sorted(((iou(a, b), i, j) for i, a in enumerate(got) for j, b in enumerate(ref)),
                   reverse=True)
    used_g, used_r = set(), set()
    for v, i, j in pairs:
        if v < at:
            break
        if i not in used_g and j not in used_r:
            used_g.add(i)
            used_r.add(j)
    return (len(got) - len(used_g)) + (len(ref) - len(used_r))
