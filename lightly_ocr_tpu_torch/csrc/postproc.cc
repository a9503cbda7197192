// Exact host-side CRAFT box extraction — the native counterpart of the
// OpenCV path the reference leans on (cv2.connectedComponentsWithStats,
// cv2.dilate, cv2.minAreaRect/boxPoints in ocr/tools/det_utils.py:35-94).
//
// The production path runs on the card (lightly_ocr_tpu_torch/ops/
// detection.py); this library is the bit-faithful host route and parity
// oracle, built with g++ by lightly_ocr_tpu_torch/ops/native.py:
//   * 4-connectivity connected components via union-find,
//   * per-component square-kernel dilation with OpenCV's even-kernel
//     anchor semantics, clipped to the reference's window,
//   * min-area rectangle via convex hull + rotating calipers,
//   * the square-box axis-align special case + clockwise corner roll.
//
// C ABI only; loaded from Python with ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int32_t> parent;
  explicit UnionFind(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (a < b) parent[b] = a; else parent[a] = b;  // min-root
  }
};

struct Pt {
  double x, y;
};

double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// Andrew monotone chain; returns hull in counter-clockwise order.
std::vector<Pt> convex_hull(std::vector<Pt> pts) {
  std::sort(pts.begin(), pts.end(), [](const Pt& a, const Pt& b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  pts.erase(std::unique(pts.begin(), pts.end(),
                        [](const Pt& a, const Pt& b) {
                          return a.x == b.x && a.y == b.y;
                        }),
            pts.end());
  const size_t n = pts.size();
  if (n < 3) return pts;
  std::vector<Pt> hull(2 * n);
  size_t k = 0;
  for (size_t i = 0; i < n; ++i) {
    while (k >= 2 && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) --k;
    hull[k++] = pts[i];
  }
  const size_t lower = k + 1;
  for (size_t i = n - 1; i-- > 0;) {
    while (k >= lower && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) --k;
    hull[k++] = pts[i];
  }
  hull.resize(k - 1);
  return hull;
}

// Min-area rect by rotating over hull edges. Emits 4 corners.
void min_area_rect(const std::vector<Pt>& pts, Pt out[4]) {
  std::vector<Pt> hull = convex_hull(pts);
  const size_t n = hull.size();
  if (n == 0) {
    for (int i = 0; i < 4; ++i) out[i] = {0, 0};
    return;
  }
  if (n == 1) {
    for (int i = 0; i < 4; ++i) out[i] = hull[0];
    return;
  }
  double best_area = 1e300;
  double bc = 1, bs = 0, bx0 = 0, bx1 = 0, by0 = 0, by1 = 0;
  for (size_t i = 0; i < n; ++i) {
    const Pt& p0 = hull[i];
    const Pt& p1 = hull[(i + 1) % n];
    double ex = p1.x - p0.x, ey = p1.y - p0.y;
    double len = std::hypot(ex, ey);
    if (len < 1e-12) continue;
    double c = ex / len, s = ey / len;
    double x0 = 1e300, x1 = -1e300, y0 = 1e300, y1 = -1e300;
    for (const Pt& p : hull) {
      double px = p.x * c + p.y * s;
      double py = -p.x * s + p.y * c;
      x0 = std::min(x0, px); x1 = std::max(x1, px);
      y0 = std::min(y0, py); y1 = std::max(y1, py);
    }
    double area = (x1 - x0) * (y1 - y0);
    if (area < best_area) {
      best_area = area;
      bc = c; bs = s; bx0 = x0; bx1 = x1; by0 = y0; by1 = y1;
    }
  }
  // corners (x0,y0) (x1,y0) (x1,y1) (x0,y1) back-rotated
  const double cx[4] = {bx0, bx1, bx1, bx0};
  const double cy[4] = {by0, by0, by1, by1};
  for (int i = 0; i < 4; ++i) {
    out[i].x = cx[i] * bc - cy[i] * bs;
    out[i].y = cx[i] * bs + cy[i] * bc;
  }
}

}  // namespace

extern "C" {

// textmap/linkmap: H*W row-major float32.
// out_boxes: max_boxes * 8 floats (4 corners x (x, y)).
// Returns the number of boxes written.
int lor_det_boxes(const float* textmap, const float* linkmap, int H, int W,
                  float text_threshold, float link_threshold, float low_text,
                  float* out_boxes, int max_boxes) {
  const size_t HW = static_cast<size_t>(H) * W;
  std::vector<uint8_t> text(HW), link(HW), fg(HW);
  for (size_t i = 0; i < HW; ++i) {
    text[i] = textmap[i] > low_text;
    link[i] = linkmap[i] > link_threshold;
    fg[i] = text[i] | link[i];
  }

  // --- 4-connectivity union-find ---
  UnionFind uf(HW);
  for (int y = 0; y < H; ++y) {
    const size_t row = static_cast<size_t>(y) * W;
    for (int x = 0; x < W; ++x) {
      const size_t i = row + x;
      if (!fg[i]) continue;
      if (x + 1 < W && fg[i + 1]) uf.unite(i, i + 1);
      if (y + 1 < H && fg[i + W]) uf.unite(i, i + W);
    }
  }
  std::vector<int32_t> root(HW, -1);
  for (size_t i = 0; i < HW; ++i)
    if (fg[i]) root[i] = uf.find(static_cast<int32_t>(i));

  // --- stats keyed by root, discovered in row-major order ---
  struct Stat {
    int64_t area = 0;
    int minx = 1 << 30, maxx = -1, miny = 1 << 30, maxy = -1;
    float peak = -1e30f;
  };
  std::vector<int32_t> order;  // roots in first-pixel order
  std::vector<int32_t> compact(HW, -1);
  std::vector<Stat> stats;
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      const size_t i = static_cast<size_t>(y) * W + x;
      if (root[i] < 0) continue;
      int32_t r = root[i];
      if (compact[r] < 0) {
        compact[r] = static_cast<int32_t>(stats.size());
        order.push_back(r);
        stats.emplace_back();
      }
      Stat& st = stats[compact[r]];
      st.area += 1;
      st.minx = std::min(st.minx, x); st.maxx = std::max(st.maxx, x);
      st.miny = std::min(st.miny, y); st.maxy = std::max(st.maxy, y);
      st.peak = std::max(st.peak, textmap[i]);
    }
  }

  int written = 0;
  std::vector<uint8_t> seg;  // window-local scratch
  for (size_t k = 0; k < stats.size() && written < max_boxes; ++k) {
    const Stat& st = stats[k];
    if (st.area < 10) continue;               // det_utils.py:51-52
    if (st.peak < text_threshold) continue;   // det_utils.py:55
    const int w = st.maxx - st.minx + 1;
    const int h = st.maxy - st.miny + 1;
    const int niter = static_cast<int>(
        std::sqrt(static_cast<double>(st.area) * std::min(w, h) /
                  (static_cast<double>(w) * h)) * 2.0);
    // clipped dilation window (det_utils.py:64-69)
    const int sx = std::max(st.minx - niter, 0);
    const int sy = std::max(st.miny - niter, 0);
    const int ex = std::min(st.maxx + niter + 2, W);  // exclusive
    const int ey = std::min(st.maxy + niter + 2, H);
    const int ww = ex - sx, wh = ey - sy;

    // window-local segmap: component pixels minus link-only pixels
    seg.assign(static_cast<size_t>(ww) * wh, 0);
    const int32_t r = order[k];
    for (int y = st.miny; y <= st.maxy; ++y) {
      for (int x = st.minx; x <= st.maxx; ++x) {
        const size_t i = static_cast<size_t>(y) * W + x;
        if (root[i] == r && !(link[i] && !text[i]))
          seg[static_cast<size_t>(y - sy) * ww + (x - sx)] = 1;
      }
    }
    // separable square dilation, OpenCV anchor: K = 1 + niter,
    // a = K / 2 -> expand `a` toward +, `K - 1 - a` toward -
    const int K = 1 + niter;
    const int plus = K / 2, minus = K - 1 - plus;
    if (niter > 0) {
      std::vector<uint8_t> tmp(seg.size(), 0);
      for (int y = 0; y < wh; ++y) {  // horizontal pass
        const uint8_t* srow = &seg[static_cast<size_t>(y) * ww];
        uint8_t* drow = &tmp[static_cast<size_t>(y) * ww];
        for (int x = 0; x < ww; ++x) {
          if (!srow[x]) continue;
          const int lo = std::max(x - minus, 0);
          const int hi = std::min(x + plus, ww - 1);
          for (int t = lo; t <= hi; ++t) drow[t] = 1;
        }
      }
      seg.assign(seg.size(), 0);
      for (int x = 0; x < ww; ++x) {  // vertical pass
        for (int y = 0; y < wh; ++y) {
          if (!tmp[static_cast<size_t>(y) * ww + x]) continue;
          const int lo = std::max(y - minus, 0);
          const int hi = std::min(y + plus, wh - 1);
          for (int t = lo; t <= hi; ++t)
            seg[static_cast<size_t>(t) * ww + x] = 1;
        }
      }
    }

    std::vector<Pt> pts;
    pts.reserve(256);
    int pminx = 1 << 30, pmaxx = -1, pminy = 1 << 30, pmaxy = -1;
    for (int y = 0; y < wh; ++y) {
      for (int x = 0; x < ww; ++x) {
        if (!seg[static_cast<size_t>(y) * ww + x]) continue;
        const int gx = x + sx, gy = y + sy;
        pts.push_back({static_cast<double>(gx), static_cast<double>(gy)});
        pminx = std::min(pminx, gx); pmaxx = std::max(pmaxx, gx);
        pminy = std::min(pminy, gy); pmaxy = std::max(pmaxy, gy);
      }
    }
    if (pts.empty()) continue;

    Pt box[4];
    min_area_rect(pts, box);

    // square special case (det_utils.py:79-84)
    const double bw = std::hypot(box[0].x - box[1].x, box[0].y - box[1].y);
    const double bh = std::hypot(box[1].x - box[2].x, box[1].y - box[2].y);
    const double ratio = std::max(bw, bh) / (std::min(bw, bh) + 1e-5);
    if (std::fabs(1.0 - ratio) <= 0.1) {
      box[0] = {(double)pminx, (double)pminy};
      box[1] = {(double)pmaxx, (double)pminy};
      box[2] = {(double)pmaxx, (double)pmaxy};
      box[3] = {(double)pminx, (double)pmaxy};
    }

    // clockwise roll: start at min(x+y) (det_utils.py:87-88)
    int start = 0;
    double best = box[0].x + box[0].y;
    for (int i = 1; i < 4; ++i) {
      const double s = box[i].x + box[i].y;
      if (s < best) { best = s; start = i; }
    }
    for (int i = 0; i < 4; ++i) {
      const Pt& p = box[(start + i) % 4];
      out_boxes[written * 8 + i * 2 + 0] = static_cast<float>(p.x);
      out_boxes[written * 8 + i * 2 + 1] = static_cast<float>(p.y);
    }
    ++written;
  }
  return written;
}

// Connected-component labeling only (cv2.connectedComponents parity).
// out_labels: H*W int32, 0 = background, components numbered from 1 in
// row-major first-pixel order. Returns number of components + 1.
int lor_label_components(const uint8_t* mask, int H, int W,
                         int32_t* out_labels) {
  const size_t HW = static_cast<size_t>(H) * W;
  UnionFind uf(HW);
  for (int y = 0; y < H; ++y) {
    const size_t row = static_cast<size_t>(y) * W;
    for (int x = 0; x < W; ++x) {
      const size_t i = row + x;
      if (!mask[i]) continue;
      if (x + 1 < W && mask[i + 1]) uf.unite(i, i + 1);
      if (y + 1 < H && mask[i + W]) uf.unite(i, i + W);
    }
  }
  std::vector<int32_t> compact(HW, 0);
  int next = 1;
  for (size_t i = 0; i < HW; ++i) {
    if (!mask[i]) { out_labels[i] = 0; continue; }
    int32_t r = uf.find(static_cast<int32_t>(i));
    if (compact[r] == 0) compact[r] = next++;
    out_labels[i] = compact[r];
  }
  return next;
}

}  // extern "C"
