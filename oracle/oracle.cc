// C++ reference oracle for libpillowfight_tpu (SURVEY.md §7 step 0).
//
// The upstream C source is absent from the reference mount (a 2-file stub;
// SURVEY.md §0), so golden-output parity is pinned against THIS native
// reimplementation, written from the algorithm specs in SURVEY.md §2 with
// all constants taken from the generated constants.h (single source of
// truth shared with the JAX kernels).
//
// Build: make  ->  libpf_oracle.so (ctypes, golden tests) + pf_oracle (CLI
// bench baseline). Pure C++17, double-precision math like the reference's
// pf_dbl_matrix, row-major uint8 RGBA buffers like pf_bitmap.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <string>
#include <vector>

#include "constants.h"

namespace {

using std::size_t;

struct Mat {  // double-precision plane (ref: struct pf_dbl_matrix)
  int h = 0, w = 0;
  std::vector<double> v;
  Mat() = default;
  Mat(int h_, int w_) : h(h_), w(w_), v((size_t)h_ * w_, 0.0) {}
  double& at(int y, int x) { return v[(size_t)y * w + x]; }
  double at(int y, int x) const { return v[(size_t)y * w + x]; }
  double get0(int y, int x) const {  // zero outside (conv padding contract)
    return (y < 0 || y >= h || x < 0 || x >= w) ? 0.0 : at(y, x);
  }
};

inline uint8_t clamp_u8(double x) {
  double r = std::nearbyint(x);  // round-half-even, matches XLA jnp.round
  if (r < 0) return 0;
  if (r > 255) return 255;
  return (uint8_t)r;
}

Mat gray_of(const uint8_t* rgba, int h, int w) {  // unweighted mean
  Mat g(h, w);
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      const uint8_t* p = rgba + 4 * ((size_t)y * w + x);
      g.at(y, x) = (p[0] + p[1] + p[2]) / 3.0;
    }
  return g;
}

void gray_to_rgba(const Mat& g, uint8_t* rgba) {
  for (int y = 0; y < g.h; y++)
    for (int x = 0; x < g.w; x++) {
      uint8_t* p = rgba + 4 * ((size_t)y * g.w + x);
      p[0] = p[1] = p[2] = clamp_u8(g.at(y, x));
      p[3] = 255;
    }
}

// true convolution, zero padded, SAME size (ref: pf_dbl_matrix_convolution)
Mat conv2d(const Mat& x, const Mat& k) {
  Mat out(x.h, x.w);
  int cy = k.h / 2, cx = k.w / 2;
  for (int y = 0; y < x.h; y++)
    for (int xx = 0; xx < x.w; xx++) {
      double acc = 0;
      for (int ky = 0; ky < k.h; ky++)
        for (int kx = 0; kx < k.w; kx++)
          acc += k.at(ky, kx) * x.get0(y + cy - ky, xx + cx - kx);
      out.at(y, xx) = acc;
    }
  return out;
}

std::vector<double> gaussian_kernel_1d(double sigma, int nb_stddev) {
  int hw = (int)std::ceil(sigma * nb_stddev);
  std::vector<double> k(2 * hw + 1);
  double sum = 0;
  for (int i = -hw; i <= hw; i++) {
    k[i + hw] = std::exp(-(double)(i * i) / (2 * sigma * sigma));
    sum += k[i + hw];
  }
  for (auto& e : k) e /= sum;
  return k;
}

Mat gaussian_on_matrix(const Mat& g, double sigma, int nb_stddev) {
  auto k1 = gaussian_kernel_1d(sigma, nb_stddev);
  Mat kr(1, (int)k1.size()), kc((int)k1.size(), 1);
  for (size_t i = 0; i < k1.size(); i++) {
    kr.at(0, (int)i) = k1[i];
    kc.at((int)i, 0) = k1[i];
  }
  return conv2d(conv2d(g, kr), kc);
}

struct Grad {
  Mat intensity, direction;
};

Grad sobel_on_matrix(const Mat& g) {
  // correlation semantics (gradient points dark->light): conv2d performs
  // true convolution, so feed it the pre-flipped (negated) Sobel taps.
  Mat gxk(3, 3), gyk(3, 3);
  double sx[9] = {1, 0, -1, 2, 0, -2, 1, 0, -1};
  for (int i = 0; i < 9; i++) {
    gxk.v[i] = sx[i];
    gyk.at(i / 3, i % 3) = sx[(i % 3) * 3 + i / 3];  // transpose
  }
  Mat gx = conv2d(g, gxk), gy = conv2d(g, gyk);
  Grad out{Mat(g.h, g.w), Mat(g.h, g.w)};
  for (size_t i = 0; i < gx.v.size(); i++) {
    out.intensity.v[i] = std::hypot(gx.v[i], gy.v[i]);
    out.direction.v[i] = std::atan2(gy.v[i], gx.v[i]);
  }
  return out;
}

// ---------------------------------------------------------------- canny
std::vector<uint8_t> canny_edges(const Mat& gray) {
  Mat sm = gaussian_on_matrix(gray, PFT_CANNY_GAUSSIAN_SIGMA,
                              PFT_CANNY_GAUSSIAN_NB_STDDEV);
  Grad gr = sobel_on_matrix(sm);
  int h = gray.h, w = gray.w;
  // Shared spec with the JAX kernel (ops/canny.py): NMS compares the
  // intensity normalized to [0,255] and rounded to the integer grid, so
  // ridge ties break identically in f32 (JAX) and f64 (here).
  double imn = 1e300, imx = -1e300;
  for (double e : gr.intensity.v) {
    imn = std::min(imn, e);
    imx = std::max(imx, e);
  }
  double ispan = std::max(imx - imn, 1e-12);
  Mat iq(h, w);
  for (size_t i = 0; i < iq.v.size(); i++)
    iq.v[i] = std::nearbyint((gr.intensity.v[i] - imn) * 255.0 / ispan);
  // NMS, 4-bin quantization identical to the JAX kernel (ops/canny.py)
  Mat nms(h, w);
  const int dy_a[4] = {0, -1, -1, -1}, dx_a[4] = {1, 1, 0, -1};
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      double theta = std::fmod(gr.direction.at(y, x), M_PI);
      if (theta < 0) theta += M_PI;
      int bin = ((int)std::nearbyint(theta / (M_PI / 4))) % 4;
      double a = iq.get0(y + dy_a[bin], x + dx_a[bin]);
      double b = iq.get0(y - dy_a[bin], x - dx_a[bin]);
      double i0 = iq.at(y, x);
      nms.at(y, x) = (i0 >= a && i0 >= b) ? i0 : 0.0;
    }
  double peak = 0;
  for (double e : nms.v) peak = std::max(peak, e);
  double hi = peak * PFT_CANNY_HIGH_THRESHOLD_FRACTION;
  double lo = peak * PFT_CANNY_LOW_THRESHOLD_FRACTION;
  // hysteresis: BFS from strong pixels through weak ones (8-conn)
  std::vector<uint8_t> edge((size_t)h * w, 0), weak((size_t)h * w, 0);
  std::deque<int> q;
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      size_t i = (size_t)y * w + x;
      weak[i] = nms.at(y, x) >= lo;
      if (nms.at(y, x) >= hi) {
        edge[i] = 1;
        q.push_back((int)i);
      }
    }
  while (!q.empty()) {
    int i = q.front();
    q.pop_front();
    int y = i / w, x = i % w;
    for (int dy = -1; dy <= 1; dy++)
      for (int dx = -1; dx <= 1; dx++) {
        int ny = y + dy, nx = x + dx;
        if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
        size_t j = (size_t)ny * w + nx;
        if (weak[j] && !edge[j]) {
          edge[j] = 1;
          q.push_back((int)j);
        }
      }
  }
  return edge;
}

// --------------------------------------------------------- flood / labels
std::vector<int> label_components(const std::vector<uint8_t>& mask, int h,
                                  int w, bool conn8) {
  std::vector<int> lab((size_t)h * w, -1);
  std::deque<int> q;
  int next = 0;
  for (size_t s = 0; s < mask.size(); s++) {
    if (!mask[s] || lab[s] >= 0) continue;
    int id = next++;
    lab[s] = id;
    q.push_back((int)s);
    while (!q.empty()) {
      int i = q.front();
      q.pop_front();
      int y = i / w, x = i % w;
      for (int dy = -1; dy <= 1; dy++)
        for (int dx = -1; dx <= 1; dx++) {
          if (!conn8 && dy != 0 && dx != 0) continue;
          if (dy == 0 && dx == 0) continue;
          int ny = y + dy, nx = x + dx;
          if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
          size_t j = (size_t)ny * w + nx;
          if (mask[j] && lab[j] < 0) {
            lab[j] = id;
            q.push_back((int)j);
          }
        }
    }
  }
  return lab;
}

inline bool is_dark(const Mat& g, int y, int x, double thr) {
  return g.at(y, x) < thr * 255.0;
}

void wipe_px(uint8_t* rgba, int w, int y, int x) {
  uint8_t* p = rgba + 4 * ((size_t)y * w + x);
  p[0] = p[1] = p[2] = PFT_PF_WHITE;
}

}  // namespace

// ============================================================ public API
extern "C" {

void pf_oracle_gaussian(const uint8_t* in, uint8_t* out, int h, int w,
                        double sigma, int nb_stddev) {
  auto k1 = gaussian_kernel_1d(sigma, nb_stddev);
  Mat kr(1, (int)k1.size()), kc((int)k1.size(), 1);
  for (size_t i = 0; i < k1.size(); i++) {
    kr.at(0, (int)i) = k1[i];
    kc.at((int)i, 0) = k1[i];
  }
  for (int c = 0; c < 3; c++) {
    Mat plane(h, w);
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++)
        plane.at(y, x) = in[4 * ((size_t)y * w + x) + c];
    Mat b = conv2d(conv2d(plane, kr), kc);
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++)
        out[4 * ((size_t)y * w + x) + c] = clamp_u8(b.at(y, x));
  }
  for (size_t i = 0; i < (size_t)h * w; i++) out[4 * i + 3] = in[4 * i + 3];
}

void pf_oracle_sobel(const uint8_t* in, uint8_t* out, int h, int w) {
  Grad g = sobel_on_matrix(gray_of(in, h, w));
  Mat v(h, w);
  for (size_t i = 0; i < v.v.size(); i++)
    v.v[i] = std::min(255.0, std::max(0.0, g.intensity.v[i]));
  gray_to_rgba(v, out);
}

void pf_oracle_canny(const uint8_t* in, uint8_t* out, int h, int w) {
  auto edge = canny_edges(gray_of(in, h, w));
  Mat v(h, w);
  for (size_t i = 0; i < edge.size(); i++) v.v[i] = edge[i] ? 255.0 : 0.0;
  gray_to_rgba(v, out);
}

// ACE with explicit shared samples (parity mode: the JAX kernel and the
// oracle are fed identical coordinates — SURVEY.md §7 hard-part 3).
void pf_oracle_ace_samples(const uint8_t* in, uint8_t* out, int h, int w,
                           const int* sy, const int* sx, int ns, double slope,
                           double limit) {
  std::vector<double> num((size_t)h * w * 3, 0.0), den((size_t)h * w * 3, 0.0);
  for (int s = 0; s < ns; s++) {
    const uint8_t* sp = in + 4 * ((size_t)sy[s] * w + sx[s]);
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) {
        double d = std::sqrt((double)(y - sy[s]) * (y - sy[s]) +
                             (double)(x - sx[s]) * (x - sx[s]));
        d = std::max(d, 1.0);
        const uint8_t* p = in + 4 * ((size_t)y * w + x);
        for (int c = 0; c < 3; c++) {
          double delta = slope * ((double)p[c] - sp[c]);
          delta = std::min(limit, std::max(-limit, delta));
          num[3 * ((size_t)y * w + x) + c] += delta / d;
          den[3 * ((size_t)y * w + x) + c] += limit / d;
        }
      }
  }
  double lo[3] = {1e30, 1e30, 1e30}, hi[3] = {-1e30, -1e30, -1e30};
  for (size_t i = 0; i < (size_t)h * w; i++)
    for (int c = 0; c < 3; c++) {
      double n = num[3 * i + c] / den[3 * i + c];
      num[3 * i + c] = n;
      lo[c] = std::min(lo[c], n);
      hi[c] = std::max(hi[c], n);
    }
  for (size_t i = 0; i < (size_t)h * w; i++) {
    for (int c = 0; c < 3; c++) {
      double span = hi[c] - lo[c];
      double v = span > 1e-9 ? 255.0 * (num[3 * i + c] - lo[c]) / span : 127.5;
      out[4 * i + c] = clamp_u8(v);
    }
    out[4 * i + 3] = in[4 * i + 3];
  }
}

namespace {

// Shared ACE normalization: num/den [h*w*3] -> uint8 RGBA out.
void ace_finish(const uint8_t* in, uint8_t* out, int h, int w,
                std::vector<double>& num, const std::vector<double>& den) {
  double lo[3] = {1e30, 1e30, 1e30}, hi[3] = {-1e30, -1e30, -1e30};
  for (size_t i = 0; i < (size_t)h * w; i++)
    for (int c = 0; c < 3; c++) {
      double n = num[3 * i + c] / den[3 * i + c];
      num[3 * i + c] = n;
      lo[c] = std::min(lo[c], n);
      hi[c] = std::max(hi[c], n);
    }
  for (size_t i = 0; i < (size_t)h * w; i++) {
    for (int c = 0; c < 3; c++) {
      double span = hi[c] - lo[c];
      double v = span > 1e-9 ? 255.0 * (num[3 * i + c] - lo[c]) / span : 127.5;
      out[4 * i + c] = clamp_u8(v);
    }
    out[4 * i + 3] = in[4 * i + 3];
  }
}

// Accumulate one (pixel i, sample flat index j) contribution.
inline void ace_accum(const uint8_t* in, int w, size_t i, int j, double slope,
                      double limit, std::vector<double>& num,
                      std::vector<double>& den) {
  int y = (int)(i / w), x = (int)(i % w);
  int sy = j / w, sx = j % w;
  double d = std::sqrt((double)(y - sy) * (y - sy) +
                       (double)(x - sx) * (x - sx));
  d = std::max(d, 1.0);
  const uint8_t* p = in + 4 * i;
  const uint8_t* sp = in + 4 * (size_t)j;
  for (int c = 0; c < 3; c++) {
    double delta = slope * ((double)p[c] - sp[c]);
    delta = std::min(limit, std::max(-limit, delta));
    num[3 * i + c] += delta / d;
    den[3 * i + c] += limit / d;
  }
}

}  // namespace

// Per-pixel independent samples with EXPLICIT flat indices idx[h*w*ns]
// (pixel i uses idx[i*ns + s]) — parity harness for the JAX kernel's
// faithful mode="per_pixel" estimator (ref: ace.c per-pixel sampling,
// SURVEY.md §3.1): both sides consume identical samples, so the
// comparison is exact arithmetic, no RNG in the loop.
void pf_oracle_ace_pixel_samples(const uint8_t* in, uint8_t* out, int h,
                                 int w, const int* idx, int ns, double slope,
                                 double limit) {
  std::vector<double> num((size_t)h * w * 3, 0.0), den((size_t)h * w * 3, 0.0);
  for (size_t i = 0; i < (size_t)h * w; i++)
    for (int s = 0; s < ns; s++)
      ace_accum(in, w, i, idx[i * ns + s], slope, limit, num, den);
  ace_finish(in, out, h, w, num, den);
}

// Reference-faithful fully random per-pixel sampling (ref: ace.c rand()
// loop) with a deterministic xorshift64* stream — the distributional
// parity target: the JAX estimators must match its output statistics.
void pf_oracle_ace_rand(const uint8_t* in, uint8_t* out, int h, int w,
                        int ns, double slope, double limit, uint64_t seed) {
  std::vector<double> num((size_t)h * w * 3, 0.0), den((size_t)h * w * 3, 0.0);
  uint64_t st = seed * 6364136223846793005ULL + 1442695040888963407ULL;
  auto next = [&st]() {
    st ^= st >> 12;
    st ^= st << 25;
    st ^= st >> 27;
    return st * 2685821657736338717ULL;
  };
  for (size_t i = 0; i < (size_t)h * w; i++)
    for (int s = 0; s < ns; s++)
      ace_accum(in, w, i, (int)(next() % ((uint64_t)h * w)), slope, limit,
                num, den);
  ace_finish(in, out, h, w, num, den);
}

void pf_oracle_compare(const uint8_t* a, const uint8_t* b, uint8_t* diff,
                       int h, int w, int tolerance, int* n_diff) {
  int n = 0;
  for (size_t i = 0; i < (size_t)h * w; i++) {
    bool differs = false;
    for (int c = 0; c < 3; c++)
      if (std::abs((int)a[4 * i + c] - (int)b[4 * i + c]) > tolerance)
        differs = true;
    if (differs) {
      n++;
      for (int c = 0; c < 3; c++)
        diff[4 * i + c] = (uint8_t)std::abs((int)a[4 * i + c] - b[4 * i + c]);
    } else {
      diff[4 * i] = diff[4 * i + 1] = diff[4 * i + 2] = 255;
    }
    diff[4 * i + 3] = 255;
  }
  *n_diff = n;
}

// ------------------------------------------------------- unpaper family
void pf_oracle_blackfilter(const uint8_t* in, uint8_t* out, int h, int w) {
  std::memcpy(out, in, (size_t)h * w * 4);
  Mat g = gray_of(in, h, w);
  int size = PFT_BLACKFILTER_SCAN_SIZE, step = PFT_BLACKFILTER_SCAN_STEP;
  std::vector<uint8_t> dark((size_t)h * w), seed((size_t)h * w, 0);
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++)
      dark[(size_t)y * w + x] = is_dark(g, y, x, PFT_UNPAPER_BLACK_THRESHOLD);
  for (int by = 0; by + size <= h; by += step)
    for (int bx = 0; bx + size <= w; bx += step) {
      int cnt = 0;
      for (int y = by; y < by + size; y++)
        for (int x = bx; x < bx + size; x++) cnt += dark[(size_t)y * w + x];
      if (cnt >= PFT_BLACKFILTER_SCAN_THRESHOLD * size * size)
        for (int y = by; y < by + size; y++)
          for (int x = bx; x < bx + size; x++)
            seed[(size_t)y * w + x] = dark[(size_t)y * w + x];
    }
  // flood from seeds over the dark mask, wipe reached pixels. The flood
  // leaps gaps: dark pixels within Chebyshev distance
  // PFT_BLACKFILTER_INTENSITY are connected (unpaper
  // --blackfilter-intensity semantics, "larger values will leap larger
  // gaps"); gap pixels are bridges only, never filled.
  const int leap = PFT_BLACKFILTER_INTENSITY;
  std::vector<uint8_t> reach((size_t)h * w, 0);
  std::deque<int> q;
  for (size_t i = 0; i < seed.size(); i++)
    if (seed[i]) {
      reach[i] = 1;
      q.push_back((int)i);
    }
  while (!q.empty()) {
    int i = q.front();
    q.pop_front();
    int y = i / w, x = i % w;
    for (int dy = -leap; dy <= leap; dy++)
      for (int dx = -leap; dx <= leap; dx++) {
        int ny = y + dy, nx = x + dx;
        if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
        size_t j = (size_t)ny * w + nx;
        if (dark[j] && !reach[j]) {
          reach[j] = 1;
          q.push_back((int)j);
        }
      }
  }
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++)
      if (reach[(size_t)y * w + x]) wipe_px(out, w, y, x);
}

void pf_oracle_noisefilter(const uint8_t* in, uint8_t* out, int h, int w) {
  std::memcpy(out, in, (size_t)h * w * 4);
  Mat g = gray_of(in, h, w);
  std::vector<uint8_t> mask((size_t)h * w);
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++)
      mask[(size_t)y * w + x] = is_dark(g, y, x, PFT_UNPAPER_WHITE_THRESHOLD);
  auto lab = label_components(mask, h, w, true);
  int nlab = 0;
  for (int l : lab) nlab = std::max(nlab, l + 1);
  std::vector<int> cnt(nlab, 0);
  for (int l : lab)
    if (l >= 0) cnt[l]++;
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      int l = lab[(size_t)y * w + x];
      if (l >= 0 && cnt[l] <= PFT_NOISEFILTER_INTENSITY) wipe_px(out, w, y, x);
    }
}

void pf_oracle_blurfilter(const uint8_t* in, uint8_t* out, int h, int w) {
  std::memcpy(out, in, (size_t)h * w * 4);
  Mat g = gray_of(in, h, w);
  int size = PFT_BLURFILTER_SIZE, step = PFT_BLURFILTER_STEP;
  int nby = (h - size) / step + 1, nbx = (w - size) / step + 1;
  if (nby <= 0 || nbx <= 0) return;
  std::vector<double> ratio((size_t)nby * nbx, 0.0);
  for (int i = 0; i < nby; i++)
    for (int j = 0; j < nbx; j++) {
      int cnt = 0;
      for (int y = i * step; y < i * step + size; y++)
        for (int x = j * step; x < j * step + size; x++)
          cnt += is_dark(g, y, x, PFT_UNPAPER_WHITE_THRESHOLD);
      ratio[(size_t)i * nbx + j] = (double)cnt / (size * size);
    }
  int d = std::max(size / step, 1);
  for (int i = 0; i < nby; i++)
    for (int j = 0; j < nbx; j++) {
      double r = ratio[(size_t)i * nbx + j];
      if (r <= 0 || r > PFT_BLURFILTER_INTENSITY) continue;
      double nmax = 0;
      for (int di = -d; di <= d; di += d)
        for (int dj = -d; dj <= d; dj += d) {
          if (di == 0 && dj == 0) continue;
          int ni = i + di, nj = j + dj;
          if (ni < 0 || ni >= nby || nj < 0 || nj >= nbx) continue;
          nmax = std::max(nmax, ratio[(size_t)ni * nbx + nj]);
        }
      if (nmax <= PFT_BLURFILTER_INTENSITY)
        for (int y = i * step; y < i * step + size; y++)
          for (int x = j * step; x < j * step + size; x++)
            if (is_dark(g, y, x, PFT_UNPAPER_WHITE_THRESHOLD))
              wipe_px(out, w, y, x);
    }
}

void pf_oracle_grayfilter(const uint8_t* in, uint8_t* out, int h, int w) {
  std::memcpy(out, in, (size_t)h * w * 4);
  Mat g = gray_of(in, h, w);
  int size = PFT_GRAYFILTER_SIZE, step = PFT_GRAYFILTER_STEP;
  for (int by = 0; by + size <= h; by += step)
    for (int bx = 0; bx + size <= w; bx += step) {
      int dark = 0;
      double sum = 0;
      for (int y = by; y < by + size; y++)
        for (int x = bx; x < bx + size; x++) {
          dark += is_dark(g, y, x, PFT_UNPAPER_BLACK_THRESHOLD);
          sum += g.at(y, x);
        }
      if (dark == 0 &&
          sum / (size * size) > 255.0 * (1.0 - PFT_GRAYFILTER_THRESHOLD))
        for (int y = by; y < by + size; y++)
          for (int x = bx; x < bx + size; x++) wipe_px(out, w, y, x);
    }
}

void pf_oracle_border(const uint8_t* in, uint8_t* out, int h, int w) {
  std::memcpy(out, in, (size_t)h * w * 4);
  Mat g = gray_of(in, h, w);
  int size = PFT_BORDER_SCAN_SIZE, step = PFT_BORDER_SCAN_STEP;
  double thr = PFT_BORDER_SCAN_THRESHOLD;
  std::vector<double> rows(h, 0.0), cols(w, 0.0);
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      double d = is_dark(g, y, x, PFT_UNPAPER_BLACK_THRESHOLD);
      rows[y] += d;
      cols[x] += d;
    }
  auto extent = [&](const std::vector<double>& line, int n, bool rev) {
    int kmax = std::max(((n / 2 - size) / step) + 1, 1);
    for (int k = 0; k < kmax; k++) {
      double cnt = 0;
      for (int t = 0; t < size; t++) {
        int i = k * step + t;
        cnt += line[rev ? n - 1 - i : i];
      }
      if (cnt > thr) return k * step;
    }
    return kmax * step;
  };
  int top = extent(rows, h, false), bottom = extent(rows, h, true);
  int left = extent(cols, w, false), right = extent(cols, w, true);
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++)
      if (y < top || y >= h - bottom || x < left || x >= w - right)
        wipe_px(out, w, y, x);
}

void pf_oracle_masks_multi(const uint8_t* in, uint8_t* out, int h, int w,
                           const int32_t* starts_yx, int n_starts) {
  std::memcpy(out, in, (size_t)h * w * 4);
  Mat g = gray_of(in, h, w);
  int size = PFT_MASKS_SCAN_SIZE, step = PFT_MASKS_SCAN_STEP;
  double thr = PFT_MASKS_SCAN_THRESHOLD;
  std::vector<double> rows(h, 0.0), cols(w, 0.0);
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      double d = is_dark(g, y, x, PFT_UNPAPER_BLACK_THRESHOLD);
      rows[y] += d;
      cols[x] += d;
    }
  // outward search from each start point; blank strip = ratio below
  // threshold; kept content area = union of the per-start rectangles
  auto edge_low = [&](const std::vector<double>& line, int perp, int center) {
    int kmax = std::max((center - size) / step + 1, 1);
    for (int k = 0; k < kmax; k++) {
      int start = center - size - k * step;
      if (start < 0) break;
      double cnt = 0;
      for (int t = 0; t < size; t++) cnt += line[start + t];
      if (cnt < thr * size * perp) return start;
    }
    return 0;
  };
  auto edge_high = [&](const std::vector<double>& line, int n, int perp,
                       int center) {
    int kmax = std::max((n - center - size) / step + 1, 1);
    for (int k = 0; k < kmax; k++) {
      int start = center + k * step;
      if (start + size > n) break;
      double cnt = 0;
      for (int t = 0; t < size; t++) cnt += line[start + t];
      if (cnt < thr * size * perp) return start + size;
    }
    return n;
  };
  std::vector<uint8_t> keep((size_t)h * w, 0);
  for (int s = 0; s < n_starts; s++) {
    int sy = starts_yx[2 * s], sx = starts_yx[2 * s + 1];
    int left = edge_low(cols, h, sx), right = edge_high(cols, w, h, sx);
    int top = edge_low(rows, w, sy), bottom = edge_high(rows, h, w, sy);
    for (int y = top; y < bottom; y++)
      for (int x = left; x < right; x++) keep[(size_t)y * w + x] = 1;
  }
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++)
      if (!keep[(size_t)y * w + x]) wipe_px(out, w, y, x);
}

void pf_oracle_masks(const uint8_t* in, uint8_t* out, int h, int w) {
  int32_t center[2] = {h / 2, w / 2};
  pf_oracle_masks_multi(in, out, h, w, center, 1);
}

}  // extern "C"

// ------------------------------------------------------------------ swt
// Stroke Width Transform oracle (Epshtein et al. CVPR'08 / CCV DetectText;
// ref: src/pillowfight/swt.c per SURVEY.md §2.2/§3.3 — upstream source is
// absent, so this clean-room implementation of the documented spec IS the
// parity authority). Continuous ray casting from every canny edge pixel
// along ±gradient, first-edge termination with the ±pi/6 opposing-gradient
// test, per-ray median clamp, connected components over stroke-width ratio
// <= 3, letter-geometry filters, nested-box rejection, two polarity passes.
//
// Spec extension shared with the JAX kernel (ops/swt.py): a polarity
// consistency gate — the dark-on-light pass keeps only pixels darker than
// the page median and vice versa — rejects page-spanning pseudo strokes
// (inter-letter gaps on blank margins). Both sides implement it
// identically so golden parity is well-defined.

namespace {

constexpr double kSwtInf = 1e30;

struct SwtBox {
  int y0, y1, x0, x1;
};

struct SwtPass {
  std::vector<uint8_t> letter;  // h*w: accepted letter pixels
  std::vector<SwtBox> boxes;    // accepted letter bounding boxes
};

void swt_polarity(const Mat& gray, const std::vector<uint8_t>& edge,
                  const Mat& ux, const Mat& uy, double gray_median, int sign,
                  int h, int w, SwtPass& out) {
  out.letter.assign((size_t)h * w, 0);
  out.boxes.clear();
  const double ctol = std::cos(PFT_SWT_RAY_ANGLE_TOLERANCE);

  // ---- pass 1: ray casting, per-pixel min stroke width
  std::vector<double> swt((size_t)h * w, kSwtInf);
  std::vector<std::vector<int>> rays;
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      if (!edge[(size_t)y * w + x]) continue;
      double dy = sign * uy.at(y, x), dx = sign * ux.at(y, x);
      std::vector<int> ray;
      ray.push_back(y * w + x);
      double fy = y + 0.5, fx = x + 0.5;
      int py = y, px = x;
      bool valid = false;
      for (int t = 0; t < 4 * PFT_SWT_MAX_RAY_LEN; t++) {
        fy += 0.5 * dy;  // half steps so diagonal rays skip no cell
        fx += 0.5 * dx;
        int cy = (int)std::floor(fy), cx = (int)std::floor(fx);
        if (cy == py && cx == px) continue;
        if (cy < 0 || cy >= h || cx < 0 || cx >= w) break;
        py = cy;
        px = cx;
        if (std::hypot((double)(cy - y), (double)(cx - x)) >
            PFT_SWT_MAX_RAY_LEN)
          break;
        if (edge[(size_t)cy * w + cx]) {
          // Epshtein condition: hit gradient ~anti-parallel to the
          // anchor's gradient (within pi/6); first edge ends the ray
          // either way.
          double dot = ux.at(y, x) * ux.at(cy, cx) + uy.at(y, x) * uy.at(cy, cx);
          valid = dot <= -ctol;
          break;
        }
        ray.push_back(cy * w + cx);
      }
      if (!valid) continue;
      ray.push_back(py * w + px);  // the hit pixel belongs to the stroke
      double width = std::max(std::hypot((double)(py - y), (double)(px - x)), 1.0);
      for (int i : ray) swt[i] = std::min(swt[i], width);
      rays.push_back(std::move(ray));
    }

  // ---- pass 2: per-ray median clamp (ref: swt.c qsort median)
  for (const auto& ray : rays) {
    std::vector<double> vals;
    vals.reserve(ray.size());
    for (int i : ray) vals.push_back(swt[i]);
    std::sort(vals.begin(), vals.end());
    double med = vals[vals.size() / 2];
    for (int i : ray) swt[i] = std::min(swt[i], med);
  }

  // ---- polarity consistency gate (spec extension, see header comment)
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      bool pol_ok = sign < 0 ? gray.at(y, x) < gray_median
                             : gray.at(y, x) > gray_median;
      if (!pol_ok) swt[(size_t)y * w + x] = kSwtInf;
    }

  // ---- connected components over similar stroke widths (8-conn,
  // max/min ratio <= SWT_CC_SW_RATIO), BFS
  std::vector<int> lab((size_t)h * w, -1);
  int nlab = 0;
  std::deque<int> q;
  for (int s = 0; s < h * w; s++) {
    if (swt[s] >= kSwtInf || lab[s] >= 0) continue;
    int id = nlab++;
    lab[s] = id;
    q.push_back(s);
    while (!q.empty()) {
      int i = q.front();
      q.pop_front();
      int y = i / w, x = i % w;
      for (int dy = -1; dy <= 1; dy++)
        for (int dx = -1; dx <= 1; dx++) {
          if (dy == 0 && dx == 0) continue;
          int ny = y + dy, nx = x + dx;
          if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
          int j = ny * w + nx;
          if (swt[j] >= kSwtInf || lab[j] >= 0) continue;
          double a = swt[i], b = swt[j];
          if (std::max(a, b) / std::max(std::min(a, b), 1e-6) >
              PFT_SWT_CC_SW_RATIO)
            continue;
          lab[j] = id;
          q.push_back(j);
        }
    }
  }

  // ---- per-component statistics + letter filters
  std::vector<double> cnt(nlab, 0), s1(nlab, 0), s2(nlab, 0);
  std::vector<int> ymin(nlab, h), ymax(nlab, 0), xmin(nlab, w), xmax(nlab, 0);
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      int l = lab[(size_t)y * w + x];
      if (l < 0) continue;
      double v = swt[(size_t)y * w + x];
      cnt[l] += 1;
      s1[l] += v;
      s2[l] += v * v;
      ymin[l] = std::min(ymin[l], y);
      ymax[l] = std::max(ymax[l], y);
      xmin[l] = std::min(xmin[l], x);
      xmax[l] = std::max(xmax[l], x);
    }
  std::vector<uint8_t> acc(nlab, 0);
  for (int l = 0; l < nlab; l++) {
    double n = std::max(cnt[l], 1.0);
    double mean = s1[l] / n;
    double var = std::max(s2[l] / n - mean * mean, 0.0);
    double bw = xmax[l] - xmin[l] + 1, bh = ymax[l] - ymin[l] + 1;
    double diag = std::hypot(bw, bh);
    double aspect = std::max(bw, bh) / std::max(std::min(bw, bh), 1.0);
    acc[l] = cnt[l] >= PFT_SWT_LETTER_MIN_PIXELS &&
             var <= PFT_SWT_LETTER_VARIANCE_RATIO * mean * mean &&
             aspect <= PFT_SWT_LETTER_ASPECT_RATIO_MAX &&
             diag < PFT_SWT_LETTER_DIAMETER_SW_RATIO * std::max(mean, 1e-6) &&
             bh >= PFT_SWT_LETTER_HEIGHT_MIN && bh <= PFT_SWT_LETTER_HEIGHT_MAX;
  }

  // ---- nested-box rejection: an accepted box containing more than
  // SWT_MAX_NESTED_LETTERS other accepted boxes is a frame, not a letter
  std::vector<int> accepted;
  for (int l = 0; l < nlab; l++)
    if (acc[l]) accepted.push_back(l);
  std::vector<uint8_t> reject(nlab, 0);
  for (int a : accepted) {
    int nested = 0;
    for (int b : accepted) {
      if (a == b) continue;
      if (ymin[a] <= ymin[b] && ymax[a] >= ymax[b] && xmin[a] <= xmin[b] &&
          xmax[a] >= xmax[b])
        nested++;
    }
    if (nested > PFT_SWT_MAX_NESTED_LETTERS) reject[a] = 1;
  }
  for (int l = 0; l < nlab; l++)
    if (acc[l] && !reject[l])
      out.boxes.push_back({ymin[l], ymax[l], xmin[l], xmax[l]});
  for (int i = 0; i < h * w; i++) {
    int l = lab[i];
    if (l >= 0 && acc[l] && !reject[l]) out.letter[i] = 1;
  }
}

}  // namespace

extern "C" void pf_oracle_swt(const uint8_t* in, uint8_t* out, int h, int w,
                              int output_type) {
  Mat gray = gray_of(in, h, w);
  auto edge = canny_edges(gray);
  Mat sm = gaussian_on_matrix(gray, PFT_CANNY_GAUSSIAN_SIGMA,
                              PFT_CANNY_GAUSSIAN_NB_STDDEV);
  Grad gr = sobel_on_matrix(sm);
  Mat ux(h, w), uy(h, w);
  for (size_t i = 0; i < gr.direction.v.size(); i++) {
    ux.v[i] = std::cos(gr.direction.v[i]);
    uy.v[i] = std::sin(gr.direction.v[i]);
  }
  std::vector<double> sorted(gray.v);
  std::sort(sorted.begin(), sorted.end());
  size_t n = sorted.size();
  double med = n % 2 ? sorted[n / 2] : 0.5 * (sorted[n / 2 - 1] + sorted[n / 2]);

  SwtPass minus, plus;
  swt_polarity(gray, edge, ux, uy, med, -1, h, w, minus);
  swt_polarity(gray, edge, ux, uy, med, +1, h, w, plus);

  if (output_type == PFT_SWT_OUTPUT_ORIGINAL_BOXES) {
    std::memcpy(out, in, (size_t)h * w * 4);
    auto draw = [&](const SwtBox& b) {
      for (int x = b.x0; x <= b.x1; x++) {
        uint8_t *t = out + 4 * ((size_t)b.y0 * w + x),
                *u = out + 4 * ((size_t)b.y1 * w + x);
        t[0] = 255; t[1] = 0; t[2] = 0;
        u[0] = 255; u[1] = 0; u[2] = 0;
      }
      for (int y = b.y0; y <= b.y1; y++) {
        uint8_t *t = out + 4 * ((size_t)y * w + b.x0),
                *u = out + 4 * ((size_t)y * w + b.x1);
        t[0] = 255; t[1] = 0; t[2] = 0;
        u[0] = 255; u[1] = 0; u[2] = 0;
      }
    };
    for (const auto& b : minus.boxes) draw(b);
    for (const auto& b : plus.boxes) draw(b);
    return;
  }
  for (int i = 0; i < h * w; i++) {
    bool letter = minus.letter[i] || plus.letter[i];
    uint8_t v = letter ? (output_type == PFT_SWT_OUTPUT_GRAYSCALE_TEXT
                              ? clamp_u8(gray.v[i])
                              : PFT_PF_BLACK)
                       : PFT_PF_WHITE;
    out[4 * i] = out[4 * i + 1] = out[4 * i + 2] = v;
    out[4 * i + 3] = in[4 * i + 3];
  }
}

// ================================================================= CLI
#ifndef PF_ORACLE_NO_MAIN
#include <chrono>

static void make_scan_page(std::vector<uint8_t>& pg, int h, int w) {
  pg.assign((size_t)h * w * 4, 245);
  for (size_t i = 0; i < (size_t)h * w; i++) pg[4 * i + 3] = 255;
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w / 40; x++)
      pg[4 * ((size_t)y * w + x)] = pg[4 * ((size_t)y * w + x) + 1] =
          pg[4 * ((size_t)y * w + x) + 2] = 0;
  for (int y = h / 10; y < h - h / 10; y += 40)
    for (int yy = y; yy < y + 3; yy++)
      for (int x = w / 8; x < w - w / 8; x++)
        pg[4 * ((size_t)yy * w + x)] = pg[4 * ((size_t)yy * w + x) + 1] =
            pg[4 * ((size_t)yy * w + x) + 2] = 15;
}

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: pf_oracle bench-unpaper-chain H W\n");
    return 2;
  }
  std::string cmd = argv[1];
  if (cmd == "bench-unpaper-chain" && argc >= 4) {
    int h = std::atoi(argv[2]), w = std::atoi(argv[3]);
    std::vector<uint8_t> a, b;
    make_scan_page(a, h, w);
    b.resize(a.size());
    auto t0 = std::chrono::steady_clock::now();
    pf_oracle_blackfilter(a.data(), b.data(), h, w);
    pf_oracle_noisefilter(b.data(), a.data(), h, w);
    pf_oracle_blurfilter(a.data(), b.data(), h, w);
    pf_oracle_masks(b.data(), a.data(), h, w);
    pf_oracle_grayfilter(a.data(), b.data(), h, w);
    pf_oracle_border(b.data(), a.data(), h, w);
    double dt = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0)
                    .count();
    std::printf("{\"mp_per_sec\": %.4f, \"seconds\": %.4f}\n",
                (double)h * w / 1e6 / dt, dt);
    return 0;
  }
  // per-filter CPU baselines (MP/s of one oracle filter on one page)
  if (cmd == "bench-filter" && argc >= 5) {
    std::string f = argv[2];
    int h = std::atoi(argv[3]), w = std::atoi(argv[4]);
    std::vector<uint8_t> a, b;
    make_scan_page(a, h, w);
    b.resize(a.size());
    auto t0 = std::chrono::steady_clock::now();
    if (f == "sobel") pf_oracle_sobel(a.data(), b.data(), h, w);
    else if (f == "gaussian") pf_oracle_gaussian(a.data(), b.data(), h, w, 2.0, 5);
    else if (f == "canny") pf_oracle_canny(a.data(), b.data(), h, w);
    else if (f == "ace") pf_oracle_ace_rand(a.data(), b.data(), h, w, 100, 10.0, 1000.0, 7);
    else if (f == "swt") pf_oracle_swt(a.data(), b.data(), h, w, 0);
    else if (f == "blackfilter") pf_oracle_blackfilter(a.data(), b.data(), h, w);
    else if (f == "noisefilter") pf_oracle_noisefilter(a.data(), b.data(), h, w);
    else if (f == "blurfilter") pf_oracle_blurfilter(a.data(), b.data(), h, w);
    else if (f == "masks") pf_oracle_masks(a.data(), b.data(), h, w);
    else if (f == "grayfilter") pf_oracle_grayfilter(a.data(), b.data(), h, w);
    else if (f == "border") pf_oracle_border(a.data(), b.data(), h, w);
    else { std::fprintf(stderr, "unknown filter %s\n", f.c_str()); return 2; }
    double dt = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0)
                    .count();
    std::printf("{\"mp_per_sec\": %.4f, \"seconds\": %.4f}\n",
                (double)h * w / 1e6 / dt, dt);
    return 0;
  }
  std::fprintf(stderr, "unknown command %s\n", cmd.c_str());
  return 2;
}
#endif
