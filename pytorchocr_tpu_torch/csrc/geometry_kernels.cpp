// Native geometry kernels for host-side postprocess + metrics.
//
// The port's copy of pytorchocr_tpu/native/geometry_kernels.cpp, unchanged
// below this note; host code, built with g++ at first use by
// pytorchocr_tpu_torch/native.py into pytorchocr_tpu_torch/_build/.
//
// TPU-native counterpart of the reference's C++ pybind11/OpenCV/Clipper
// module (db_postprocess_fast/src/db_postprocess.cpp): the device handles
// thresholding/labeling/scoring, so the native host surface shrinks to pure
// geometry — convex hull, rotating-calipers min-area-rect, closed-form
// unclip (disk dilation of the hull), and polygon intersection / IoU
// matrices for the ICDAR evaluator.  No OpenCV/Clipper dependency; exposed
// through a plain C ABI for ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC geometry_kernels.cpp -o libocrgeom.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

static inline double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// Andrew monotone chain; returns hull in CCW order (math coords).
static std::vector<Pt> convex_hull(std::vector<Pt> pts) {
  size_t n = pts.size();
  if (n < 3) return pts;
  std::sort(pts.begin(), pts.end(), [](const Pt& a, const Pt& b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  std::vector<Pt> hull(2 * n);
  size_t k = 0;
  for (size_t i = 0; i < n; ++i) {  // lower
    while (k >= 2 && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) k--;
    hull[k++] = pts[i];
  }
  size_t lower = k + 1;
  for (size_t i = n - 1; i-- > 0;) {  // upper
    while (k >= lower && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) k--;
    hull[k++] = pts[i];
  }
  hull.resize(k - 1);
  return hull;
}

static double poly_area(const std::vector<Pt>& p) {
  double a = 0;
  size_t n = p.size();
  for (size_t i = 0; i < n; ++i) {
    size_t j = (i + 1) % n;
    a += p[i].x * p[j].y - p[j].x * p[i].y;
  }
  return 0.5 * a;
}

// Sutherland-Hodgman: clip subject by convex clip polygon (any orientation).
static std::vector<Pt> clip_convex(const std::vector<Pt>& subject,
                                   std::vector<Pt> clip) {
  if (poly_area(clip) < 0) std::reverse(clip.begin(), clip.end());
  std::vector<Pt> output = subject;
  size_t n = clip.size();
  for (size_t i = 0; i < n && !output.empty(); ++i) {
    const Pt& a = clip[i];
    const Pt& b = clip[(i + 1) % n];
    std::vector<Pt> input;
    input.swap(output);
    double ex = b.x - a.x, ey = b.y - a.y;
    Pt prev = input.back();
    double prev_side = ex * (prev.y - a.y) - ey * (prev.x - a.x);
    for (const Pt& cur : input) {
      double cur_side = ex * (cur.y - a.y) - ey * (cur.x - a.x);
      if (cur_side >= 0) {
        if (prev_side < 0) {
          double t = prev_side / (prev_side - cur_side);
          output.push_back({prev.x + t * (cur.x - prev.x),
                            prev.y + t * (cur.y - prev.y)});
        }
        output.push_back(cur);
      } else if (prev_side >= 0) {
        double t = prev_side / (prev_side - cur_side);
        output.push_back({prev.x + t * (cur.x - prev.x),
                          prev.y + t * (cur.y - prev.y)});
      }
      prev = cur;
      prev_side = cur_side;
    }
  }
  return output;
}

static bool is_convex(const std::vector<Pt>& p) {
  size_t n = p.size();
  if (n < 4) return true;
  bool pos = false, neg = false;
  for (size_t i = 0; i < n; ++i) {
    double c = cross(p[i], p[(i + 1) % n], p[(i + 2) % n]);
    if (c > 1e-9) pos = true;
    if (c < -1e-9) neg = true;
    if (pos && neg) return false;
  }
  return true;
}

static std::vector<Pt> to_pts(const float* data, int n) {
  std::vector<Pt> out(n);
  for (int i = 0; i < n; ++i) out[i] = {data[2 * i], data[2 * i + 1]};
  return out;
}

}  // namespace

extern "C" {

// Rotating-calipers min-area rect over n points.
// out: 8 floats (4 corners, arbitrary start, CCW) + out_sside (short side).
// Returns 0 on success.
int min_area_rect(const float* points, int n, float* out, float* out_sside) {
  if (n < 1) return -1;
  std::vector<Pt> hull = convex_hull(to_pts(points, n));
  size_t m = hull.size();
  if (m == 1) {
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = (float)hull[0].x;
      out[2 * i + 1] = (float)hull[0].y;
    }
    *out_sside = 0;
    return 0;
  }
  if (m == 2) {
    out[0] = (float)hull[0].x; out[1] = (float)hull[0].y;
    out[2] = (float)hull[1].x; out[3] = (float)hull[1].y;
    out[4] = (float)hull[1].x; out[5] = (float)hull[1].y;
    out[6] = (float)hull[0].x; out[7] = (float)hull[0].y;
    *out_sside = 0;
    return 0;
  }

  double best_area = 1e300;
  double bx[4] = {0, 0, 0, 0}, by[4] = {0, 0, 0, 0};
  for (size_t i = 0; i < m; ++i) {
    size_t j = (i + 1) % m;
    double ex = hull[j].x - hull[i].x;
    double ey = hull[j].y - hull[i].y;
    double len = std::sqrt(ex * ex + ey * ey);
    if (len < 1e-12) continue;
    ex /= len;
    ey /= len;
    // project hull onto edge direction (u) and normal (v)
    double umin = 1e300, umax = -1e300, vmin = 1e300, vmax = -1e300;
    for (const Pt& p : hull) {
      double u = p.x * ex + p.y * ey;
      double v = -p.x * ey + p.y * ex;
      umin = std::min(umin, u); umax = std::max(umax, u);
      vmin = std::min(vmin, v); vmax = std::max(vmax, v);
    }
    double area = (umax - umin) * (vmax - vmin);
    if (area < best_area) {
      best_area = area;
      const double us[4] = {umin, umax, umax, umin};
      const double vs[4] = {vmin, vmin, vmax, vmax};
      for (int k = 0; k < 4; ++k) {
        bx[k] = us[k] * ex - vs[k] * ey;
        by[k] = us[k] * ey + vs[k] * ex;
      }
    }
  }
  double w = std::hypot(bx[1] - bx[0], by[1] - by[0]);
  double h = std::hypot(bx[3] - bx[0], by[3] - by[0]);
  for (int k = 0; k < 4; ++k) {
    out[2 * k] = (float)bx[k];
    out[2 * k + 1] = (float)by[k];
  }
  *out_sside = (float)std::min(w, h);
  return 0;
}

// Intersection area of polygon a (na pts) and polygon b (nb pts).
// Requires at least one convex operand; returns -1.0 if both non-convex.
double poly_intersection_area(const float* a, int na, const float* b, int nb) {
  if (na < 3 || nb < 3) return 0.0;
  std::vector<Pt> pa = to_pts(a, na);
  std::vector<Pt> pb = to_pts(b, nb);
  std::vector<Pt> clipped;
  if (is_convex(pb)) {
    clipped = clip_convex(pa, pb);
  } else if (is_convex(pa)) {
    clipped = clip_convex(pb, pa);
  } else {
    return -1.0;  // caller falls back to rasterization
  }
  if (clipped.size() < 3) return 0.0;
  return std::fabs(poly_area(clipped));
}

double polygon_area_abs(const float* a, int na) {
  if (na < 3) return 0.0;
  return std::fabs(poly_area(to_pts(a, na)));
}

// IoU matrix: gts (n_gt polygons, each gt_pts points flattened xy),
// dets likewise; out is n_gt * n_det row-major.  Polygons are fixed-arity
// here (the evaluator pads to a common point count).
// Pairs where both polys are non-convex get IoU -1 (caller recomputes).
void iou_matrix(const float* gts, int n_gt, int gt_pts, const float* dets,
                int n_det, int det_pts, float* out) {
  std::vector<double> gt_area(n_gt), det_area(n_det);
  for (int i = 0; i < n_gt; ++i)
    gt_area[i] = polygon_area_abs(gts + i * gt_pts * 2, gt_pts);
  for (int j = 0; j < n_det; ++j)
    det_area[j] = polygon_area_abs(dets + j * det_pts * 2, det_pts);
  for (int i = 0; i < n_gt; ++i) {
    for (int j = 0; j < n_det; ++j) {
      double inter = poly_intersection_area(gts + i * gt_pts * 2, gt_pts,
                                            dets + j * det_pts * 2, det_pts);
      if (inter < 0) {
        out[i * n_det + j] = -1.0f;
        continue;
      }
      double uni = gt_area[i] + det_area[j] - inter;
      out[i * n_det + j] = uni <= 0 ? 0.0f : (float)(inter / uni);
    }
  }
}

// Fused distance field for MakeBorderMap (the det-GT host hot loop,
// reference pytocr/data/imaug/make_border_map.py:100-157): for every pixel
// of an H x W ROI grid, the min over polygon edges of the reference's
// law-of-cosines "segment distance".  The numpy formulation materializes
// ~15 ROI-sized temporaries per edge; this is one fused pass.
// poly: n points (x, y) in ROI coordinates.  Outputs (both H*W row-major):
//   dist_norm = clip(min_d / distance, 0, 1)   (the threshold-map field)
//   absdist   = min_d                          (for the dilated-band test)
void border_distance_field(const float* poly, int n, double distance,
                           int height, int width, float* dist_norm,
                           float* absdist) {
  for (int y = 0; y < height; ++y) {
    float* dn_row = dist_norm + (size_t)y * width;
    float* ad_row = absdist + (size_t)y * width;
    for (int x = 0; x < width; ++x) {
      // min over edges on SQUARED distance; one sqrt per pixel.  The
      // law-of-cosines distance is sqrt-free: with q = (sd-sd1-sd2)/2,
      // cosin = q / sqrt(sd1*sd2), so d^2 = sd1*sd2*(1-cosin^2)/sd
      //       = (sd1*sd2 - q^2)/sd, and cosin<0 <=> q<0.
      double best2 = 1e300;
      for (int i = 0; i < n; ++i) {
        int j = (i + 1 == n) ? 0 : i + 1;
        double x1 = poly[2 * i], y1 = poly[2 * i + 1];
        double x2 = poly[2 * j], y2 = poly[2 * j + 1];
        double dx1 = x - x1, dy1 = y - y1;
        double dx2 = x - x2, dy2 = y - y2;
        double sd1 = dx1 * dx1 + dy1 * dy1;
        double sd2 = dx2 * dx2 + dy2 * dy2;
        double ex = x1 - x2, ey = y1 - y2;
        double sd = ex * ex + ey * ey;
        double d2;
        if (sd < 1e-12) {
          d2 = sd1;
        } else {
          double q = 0.5 * (sd - sd1 - sd2);
          if (q < 0) {
            d2 = std::min(sd1, sd2);
          } else {
            d2 = sd1 * sd2 - q * q;  // >= 0 up to round-off
            d2 = (d2 < 0 ? 0 : d2) / sd;
          }
        }
        if (d2 < best2) best2 = d2;
      }
      double best = std::sqrt(best2);
      double dn = best / distance;
      dn_row[x] = (float)(dn > 1 ? 1 : (dn < 0 ? 0 : dn));
      ad_row[x] = (float)best;
    }
  }
}

// Whole-sample MakeBorderMap: for every non-ignored polygon, fmax the
// normalized inverse distance field into `canvas` and set `mask` over the
// dilated band (reference make_border_map.py:44-107, one C call per sample
// instead of ~15 numpy temporaries per edge per polygon).
// polys: (n_polys, n_pts, 2) float32; ignore: n_polys uint8;
// canvas/mask: H*W float32, canvas fmax-updated with values in [0,1].
// Band membership = inside the polygon (even-odd rule) OR within
// `distance` of an edge; for pixels farther than `distance` from every
// edge the even-odd test agrees with the numpy path's cv2.fillPoly
// (differences exist only within ~1px of the boundary, where the
// distance term already includes the pixel whenever distance >= ~1.2).
void make_border_map(const float* polys, int n_polys, int n_pts,
                     const uint8_t* ignore, double shrink_ratio, int H,
                     int W, float* canvas, float* mask) {
  std::vector<double> px(n_pts), py(n_pts);
  for (int p = 0; p < n_polys; ++p) {
    if (ignore && ignore[p]) continue;
    const float* poly = polys + (size_t)p * n_pts * 2;
    double area = 0, perim = 0;
    double xmin = 1e300, xmax = -1e300, ymin = 1e300, ymax = -1e300;
    for (int i = 0; i < n_pts; ++i) {
      px[i] = poly[2 * i];
      py[i] = poly[2 * i + 1];
      xmin = std::min(xmin, px[i]); xmax = std::max(xmax, px[i]);
      ymin = std::min(ymin, py[i]); ymax = std::max(ymax, py[i]);
    }
    for (int i = 0; i < n_pts; ++i) {
      int j = (i + 1 == n_pts) ? 0 : i + 1;
      area += px[i] * py[j] - px[j] * py[i];
      perim += std::hypot(px[j] - px[i], py[j] - py[i]);
    }
    area = std::fabs(0.5 * area);
    if (area <= 0 || perim <= 0) continue;
    double distance =
        area * (1.0 - shrink_ratio * shrink_ratio) / perim;
    double dist2 = distance * distance;
    int pad = (int)std::ceil(distance) + 1;
    int x0 = std::max(0, (int)std::floor(xmin) - pad);
    int x1 = std::min(W - 1, (int)std::ceil(xmax) + pad);
    int y0 = std::max(0, (int)std::floor(ymin) - pad);
    int y1 = std::min(H - 1, (int)std::ceil(ymax) + pad);
    for (int y = y0; y <= y1; ++y) {
      float* c_row = canvas + (size_t)y * W;
      float* m_row = mask + (size_t)y * W;
      for (int x = x0; x <= x1; ++x) {
        double best2 = 1e300;
        for (int i = 0; i < n_pts; ++i) {
          int j = (i + 1 == n_pts) ? 0 : i + 1;
          double dx1 = x - px[i], dy1 = y - py[i];
          double dx2 = x - px[j], dy2 = y - py[j];
          double sd1 = dx1 * dx1 + dy1 * dy1;
          double sd2 = dx2 * dx2 + dy2 * dy2;
          double ex = px[i] - px[j], ey = py[i] - py[j];
          double sd = ex * ex + ey * ey;
          double d2;
          if (sd < 1e-12) {
            d2 = sd1;
          } else {
            double q = 0.5 * (sd - sd1 - sd2);
            if (q < 0) {
              d2 = std::min(sd1, sd2);
            } else {
              d2 = sd1 * sd2 - q * q;
              d2 = (d2 < 0 ? 0 : d2) / sd;
            }
          }
          if (d2 < best2) best2 = d2;
        }
        bool in_band = best2 <= dist2;
        if (!in_band) {
          // even-odd point-in-polygon (only reached > distance from edges)
          bool inside = false;
          for (int i = 0; i < n_pts; ++i) {
            int j = (i + 1 == n_pts) ? 0 : i + 1;
            if ((py[i] > y) != (py[j] > y)) {
              double xi =
                  px[i] + (y - py[i]) / (py[j] - py[i]) * (px[j] - px[i]);
              if (x < xi) inside = !inside;
            }
          }
          in_band = inside;
        }
        if (in_band) {
          double dn = std::sqrt(best2) / distance;
          dn = dn > 1 ? 1 : (dn < 0 ? 0 : dn);
          float v = (float)(1.0 - dn);
          if (v > c_row[x]) c_row[x] = v;
          m_row[x] = 1.0f;
        }
      }
    }
  }
}

}  // extern "C"
