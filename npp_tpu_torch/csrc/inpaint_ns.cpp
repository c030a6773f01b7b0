// Navier-Stokes inpainting of 8-bit images (host CPU), the port's own
// replacement for cv2.inpaint(src, mask, radius, cv2.INPAINT_NS), which
// npp_tpu's seam-aware residual composite calls
// (npp_tpu/models/completion.py::seam_residual_correction). Built by
// npp_tpu_torch/kernels/build.py::build_host_library with g++ and bound
// with ctypes (npp_tpu_torch/ops/inpaint.py).
//
// The method (Bertalmio, Bertozzi, Sapiro, CVPR 2001, in OpenCV's
// fast-marching form): unknown pixels are filled in the order a fast
// marching front reaches them from the hole's boundary; each new pixel is
// a weighted mean of the known pixels within `radius`, weighted by
// 1 / (|r|^4 + 1) times how well the offset r lines up with the
// neighbour's isophote (its intensity gradient turned by 90 degrees).
//
// What makes the result equal OpenCV's pixel for pixel, and is kept here
// on purpose:
//  - the state arrays (flags f, arrival times T) carry a one-pixel border;
//  - the first narrow band is the cross-dilated hole minus the hole, all
//    at T = 0, queued in raster order;
//  - the queue pops the least T, ties first in, first out: a new entry
//    goes after every entry whose T is less than or equal to its own
//    (a (T, push count) key here);
//  - T is solved in double and stored as float; the weights, the gradient
//    sums and the accumulators are float; the mean is divided in double
//    and rounded half to even with saturation (cv::saturate_cast<uchar>);
//  - gradients are per channel, with one-sided differences next to
//    unknown pixels, read through OpenCV's clamped row and column indices
//    (km, kp, lm, lp below: in the first and last rows and columns they
//    shift the stencil by one), while the neighbour's own value is read at
//    its position: holes that touch the image's border are filled too;
//  - the radius is rounded (cvRound) and clamped to 1..100.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <queue>
#include <vector>

namespace {

constexpr uint8_t KNOWN = 0;   // known, outside the narrow band
constexpr uint8_t BAND = 1;    // narrow band (known)
constexpr uint8_t INSIDE = 2;  // unknown

struct Entry {
  float t;
  long long seq;
  int i, j;
};

struct Later {
  bool operator()(const Entry& a, const Entry& b) const {
    if (a.t != b.t) return a.t > b.t;
    return a.seq > b.seq;
  }
};

class Queue {
 public:
  void push(int i, int j, float t) { q_.push(Entry{t, seq_++, i, j}); }
  bool pop(int* i, int* j) {
    if (q_.empty()) return false;
    *i = q_.top().i;
    *j = q_.top().j;
    q_.pop();
    return true;
  }

 private:
  std::priority_queue<Entry, std::vector<Entry>, Later> q_;
  long long seq_ = 0;
};

// round half to even, as cvRound on x86 (SSE2 cvtsd2si, default rounding)
inline int round_even(double v) { return static_cast<int>(std::nearbyint(v)); }

inline uint8_t saturate_u8(double v) {
  int r = round_even(v);
  return static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
}

struct Grid {
  int rows, cols;  // padded
  std::vector<uint8_t> f;
  std::vector<float> t;
  uint8_t& F(int i, int j) { return f[static_cast<size_t>(i) * cols + j]; }
  float& T(int i, int j) { return t[static_cast<size_t>(i) * cols + j]; }
};

float solve(Grid& g, int i1, int j1, int i2, int j2) {
  double sol;
  double a11 = g.T(i1, j1), a22 = g.T(i2, j2);
  double m12 = a11 < a22 ? a11 : a22;
  if (g.F(i1, j1) != INSIDE) {
    if (g.F(i2, j2) != INSIDE) {
      if (std::fabs(a11 - a22) >= 1.0)
        sol = 1 + m12;
      else
        sol = (a11 + a22 + std::sqrt((double)(2 - (a11 - a22) * (a11 - a22)))) * 0.5;
    } else {
      sol = 1 + a11;
    }
  } else if (g.F(i2, j2) != INSIDE) {
    sol = 1 + a22;
  } else {
    sol = 1 + m12;
  }
  return (float)sol;
}

inline float min4(float a, float b, float c, float d) {
  a = a < b ? a : b;
  c = c < d ? c : d;
  return a < c ? a : c;
}

}  // namespace

extern "C" {

// src, dst: rows x cols x cn uint8 (cn 1 or 3), mask: rows x cols uint8
// (non-zero = unknown). dst may not alias src. Returns 0, or -1 for a bad
// argument.
int npp_inpaint_ns(const uint8_t* src, const uint8_t* mask, uint8_t* dst,
                   int rows, int cols, int cn, double radius) {
  if (rows <= 0 || cols <= 0 || (cn != 1 && cn != 3)) return -1;
  int range = round_even(radius);
  range = range < 1 ? 1 : (range > 100 ? 100 : range);
  const size_t n = static_cast<size_t>(rows) * cols * cn;
  for (size_t k = 0; k < n; ++k) dst[k] = src[k];

  Grid g;
  g.rows = rows + 2;
  g.cols = cols + 2;
  g.f.assign(static_cast<size_t>(g.rows) * g.cols, KNOWN);
  g.t.assign(static_cast<size_t>(g.rows) * g.cols, 1.0e6f);
  std::vector<uint8_t> hole(g.f.size(), 0);
  auto H = [&](int i, int j) -> uint8_t& {
    return hole[static_cast<size_t>(i) * g.cols + j];
  };
  for (int i = 0; i < rows; ++i)
    for (int j = 0; j < cols; ++j)
      if (mask[static_cast<size_t>(i) * cols + j]) H(i + 1, j + 1) = 1;

  // narrow band: cross dilation of the hole minus the hole, border cleared
  Queue heap;
  for (int i = 1; i < g.rows - 1; ++i) {
    for (int j = 1; j < g.cols - 1; ++j) {
      if (H(i, j)) continue;
      bool near = H(i - 1, j) || H(i + 1, j) || H(i, j - 1) || H(i, j + 1);
      if (near) {
        g.F(i, j) = BAND;
        g.T(i, j) = 0.0f;
        heap.push(i, j, 0.0f);
      }
    }
  }
  for (int i = 0; i < g.rows; ++i)
    for (int j = 0; j < g.cols; ++j)
      if (H(i, j)) g.F(i, j) = INSIDE;

  const int ostride = cols * cn;
  auto O = [&](int i, int j, int c) -> uint8_t& {
    return dst[static_cast<size_t>(i) * ostride + static_cast<size_t>(j) * cn + c];
  };

  int ii, jj;
  while (heap.pop(&ii, &jj)) {
    g.F(ii, jj) = KNOWN;
    for (int q = 0; q < 4; ++q) {
      int i, j;
      if (q == 0) { i = ii - 1; j = jj; }
      else if (q == 1) { i = ii; j = jj - 1; }
      else if (q == 2) { i = ii + 1; j = jj; }
      else { i = ii; j = jj + 1; }
      if (i <= 0 || j <= 0 || i > g.rows - 1 || j > g.cols - 1) continue;
      if (g.F(i, j) != INSIDE) continue;

      float dist = min4(solve(g, i - 1, j, i, j - 1), solve(g, i + 1, j, i, j - 1),
                        solve(g, i - 1, j, i, j + 1), solve(g, i + 1, j, i, j + 1));
      g.T(i, j) = dist;

      float Ia[3] = {0, 0, 0};
      float s[3] = {1.0e-20f, 1.0e-20f, 1.0e-20f};
      for (int k = i - range; k <= i + range; ++k) {
        int km = k - 1 + (k == 1), kp = k - 1 - (k == g.rows - 2);
        for (int l = j - range; l <= j + range; ++l) {
          int lm = l - 1 + (l == 1), lp = l - 1 - (l == g.cols - 2);
          if (!(k > 0 && l > 0 && k < g.rows - 1 && l < g.cols - 1)) continue;
          if (g.F(k, l) == INSIDE ||
              (l - j) * (l - j) + (k - i) * (k - i) > range * range)
            continue;
          for (int c = 0; c < cn; ++c) {
            float ry = (float)(k - i), rx = (float)(l - j);
            float len_r = rx * rx + ry * ry;
            float dst_w = 1 / (len_r * len_r + 1);
            float gx, gy;
            if (g.F(k + 1, l) != INSIDE) {
              if (g.F(k - 1, l) != INSIDE)
                gx = (float)(std::abs(O(kp + 1, lm, c) - O(kp, lm, c)) +
                             std::abs(O(kp, lm, c) - O(km - 1, lm, c)));
              else
                gx = (float)(std::abs(O(kp + 1, lm, c) - O(kp, lm, c))) * 2.0f;
            } else {
              if (g.F(k - 1, l) != INSIDE)
                gx = (float)(std::abs(O(kp, lm, c) - O(km - 1, lm, c))) * 2.0f;
              else
                gx = 0;
            }
            if (g.F(k, l + 1) != INSIDE) {
              if (g.F(k, l - 1) != INSIDE)
                gy = (float)(std::abs(O(km, lp + 1, c) - O(km, lm, c)) +
                             std::abs(O(km, lm, c) - O(km, lm - 1, c)));
              else
                gy = (float)(std::abs(O(km, lp + 1, c) - O(km, lm, c))) * 2.0f;
            } else {
              if (g.F(k, l - 1) != INSIDE)
                gy = (float)(std::abs(O(km, lm, c) - O(km, lm - 1, c))) * 2.0f;
              else
                gy = 0;
            }
            gx = -gx;
            float dir = rx * gx + ry * gy;
            if (std::fabs(dir) <= 0.01) {
              dir = 0.000001f;
            } else {
              float len_g = gx * gx + gy * gy;
              dir = (float)std::fabs((rx * gx + ry * gy) / std::sqrt(len_r * len_g));
            }
            float w = dst_w * dir;
            Ia[c] += (float)w * (float)(O(k - 1, l - 1, c));
            s[c] += w;
          }
        }
      }
      for (int c = 0; c < cn; ++c)
        O(i - 1, j - 1, c) = saturate_u8((double)Ia[c] / s[c]);
      g.F(i, j) = BAND;
      heap.push(i, j, dist);
    }
  }
  return 0;
}

}  // extern "C"
