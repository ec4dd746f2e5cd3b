// fastimage: native host-side image kernels for the data pipeline.
//
// Bit-exact re-implementations of the two PIL operations that dominate the
// host input pipeline's per-frame cost (docs/PERF.md "Host input pipeline":
// short-side bicubic resize 1.7 ms + rotate 0.4 ms of ~3.5 ms/frame at
// 480p) plus the [0,255] -> [-1,1] float conversion. The reference pipeline
// is PIL-based (reference data/image_pair_dataloader.py:99-133,
// utils/data.py:39-70); parity therefore means "byte-identical to PIL",
// which these kernels are (asserted against PIL itself in
// tests/test_native.py, and re-checked at import by a runtime self-test in
// kpvid_tpu/native/__init__.py before the pipeline will use them).
//
// Resize: Pillow's two-pass separable resampling (horizontal first, then
// vertical) with the bicubic kernel (a = -0.5, support 2), coefficients
// quantized to 1<<22 fixed point, the intermediate pass clipped to u8 —
// the exact arithmetic of Pillow's 8-bit path, including its rounding
// (half away from zero on coefficients, +2^21 bias then arithmetic
// shift on accumulators). Internally planar per channel so both passes
// auto-vectorize; Pillow processes interleaved RGBX scalar pixels.
//
// Rotate: PIL Image.rotate(angle, NEAREST, expand=False) is an inverse
// affine map with truncation sampling and zero fill; the 6-entry matrix is
// computed on the Python side (replicating Image.rotate's round(.., 15)
// exactly) and applied here with incremental stepping.
//
// Build: g++ -O3 -march=native -shared (see kpvid_tpu/native/__init__.py;
// no external dependencies). Single-threaded by design — the pipeline's
// worker threads provide the parallelism, and ctypes releases the GIL for
// the call's duration so workers scale with host cores.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow's 8-bit fixed point

inline uint8_t clip8(int32_t in) {
  int32_t v = in >> kPrecisionBits;  // arithmetic shift, like Pillow
  if (v < 0) return 0;
  if (v > 255) return 255;
  return (uint8_t)v;
}

inline double bicubic_filter(double x) {
  // Pillow Resample.c bicubic, a = -0.5
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Pillow precompute_coeffs + normalize_coeffs_8bpc for a full-extent box.
int precompute_coeffs(int in_size, int out_size, std::vector<int>& bounds,
                      std::vector<int32_t>& kk) {
  double scale = (double)in_size / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 2.0 * filterscale;
  int ksize = (int)ceil(support) * 2 + 1;
  bounds.assign((size_t)out_size * 2, 0);
  kk.assign((size_t)out_size * ksize, 0);
  std::vector<double> k(ksize);
  for (int xx = 0; xx < out_size; xx++) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    int x = 0;
    for (; x < xmax; x++) {
      double w = bicubic_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; x++)
      if (ww != 0.0) k[x] /= ww;
    for (; x < ksize; x++) k[x] = 0;
    for (x = 0; x < ksize; x++) {
      double v = k[x] * (double)(1 << kPrecisionBits);
      kk[(size_t)xx * ksize + x] = (int32_t)(v < 0 ? v - 0.5 : v + 0.5);
    }
    bounds[(size_t)xx * 2 + 0] = xmin;
    bounds[(size_t)xx * 2 + 1] = xmax;
  }
  return ksize;
}

}  // namespace

extern "C" {

// Bicubic resize of packed u8 HWC data, bit-exact to
// PIL.Image.resize((dw, dh)) (Pillow default filter = BICUBIC).
// src: sh x sw x ch, dst: dh x dw x ch. Returns 0 on success.
int ki_resize_bicubic_u8(const uint8_t* src, int sw, int sh, uint8_t* dst,
                         int dw, int dh, int ch) {
  if (sw <= 0 || sh <= 0 || dw <= 0 || dh <= 0 || ch <= 0) return 1;
  std::vector<int> hb, vb;
  std::vector<int32_t> hk, vk;
  const int hks = precompute_coeffs(sw, dw, hb, hk);
  const int vks = precompute_coeffs(sh, dh, vb, vk);

  // horizontal pass: (sh x sw x ch) -> (sh x dw x ch), intermediate
  // clipped to u8 exactly like Pillow's ImagingResampleHorizontal_8bpc.
  // Interleaved accumulation: per output pixel the taps are contiguous
  // pixel triplets, and the ch accumulators form independent dependency
  // chains.
  std::vector<uint8_t> tmp((size_t)sh * dw * ch);
  for (int y = 0; y < sh; y++) {
    const uint8_t* row = src + (size_t)y * sw * ch;
    uint8_t* out = &tmp[(size_t)y * dw * ch];
    if (ch == 3) {
      for (int xx = 0; xx < dw; xx++) {
        const int xmax = hb[(size_t)xx * 2 + 1];
        const int32_t* k = &hk[(size_t)xx * hks];
        const uint8_t* p = row + (size_t)hb[(size_t)xx * 2] * 3;
        int32_t s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
        for (int x = 0; x < xmax; x++) {
          const int32_t kv = k[x];
          s0 += (int32_t)p[0] * kv;
          s1 += (int32_t)p[1] * kv;
          s2 += (int32_t)p[2] * kv;
          p += 3;
        }
        out[xx * 3 + 0] = clip8(s0);
        out[xx * 3 + 1] = clip8(s1);
        out[xx * 3 + 2] = clip8(s2);
      }
    } else {
      for (int xx = 0; xx < dw; xx++) {
        const int xmax = hb[(size_t)xx * 2 + 1];
        const int32_t* k = &hk[(size_t)xx * hks];
        const uint8_t* p = row + (size_t)hb[(size_t)xx * 2] * ch;
        for (int c = 0; c < ch; c++) {
          int32_t ss = 1 << (kPrecisionBits - 1);
          for (int x = 0; x < xmax; x++) ss += (int32_t)p[x * ch + c] * k[x];
          out[xx * ch + c] = clip8(ss);
        }
      }
    }
  }

  // vertical pass: (sh x dw x ch) -> (dh x dw x ch); whole interleaved
  // rows accumulate contiguously (auto-vectorizes)
  const int rowlen = dw * ch;
  std::vector<int32_t> acc(rowlen);
  for (int yy = 0; yy < dh; yy++) {
    const int ymin = vb[(size_t)yy * 2];
    const int ymax = vb[(size_t)yy * 2 + 1];
    const int32_t* k = &vk[(size_t)yy * vks];
    for (int i = 0; i < rowlen; i++) acc[i] = 1 << (kPrecisionBits - 1);
    for (int r = 0; r < ymax; r++) {
      const uint8_t* row = &tmp[(size_t)(ymin + r) * rowlen];
      const int32_t kr = k[r];
      for (int i = 0; i < rowlen; i++) acc[i] += (int32_t)row[i] * kr;
    }
    uint8_t* out = dst + (size_t)yy * rowlen;
    for (int i = 0; i < rowlen; i++) out[i] = clip8(acc[i]);
  }
  return 0;
}

// Inverse-affine NEAREST transform of packed u8 HWC data with zero fill:
// the kernel under PIL Image.rotate(angle, NEAREST, expand=False) /
// Image.transform(AFFINE). m is PIL's 6-entry output->input matrix
// (computed Python-side to replicate Image.rotate's rounding); sampling
// replicates Pillow's ImagingTransformAffine NEAREST fast path: 16.16
// fixed-point coordinates xin = FIX(a2 + a0*0.5 + a1*0.5) stepped
// incrementally by FIX(a0)/FIX(a1), floored via arithmetic shift.
int ki_affine_nearest_u8(const uint8_t* src, int w, int h, uint8_t* dst,
                         const double* m, int ch) {
  if (w <= 0 || h <= 0 || ch <= 0 || ch > 16) return 1;
  auto fix = [](double v) -> int64_t {
    return (int64_t)floor(v * 65536.0 + 0.5);
  };
  const int64_t a0 = fix(m[0]), a1 = fix(m[1]);
  const int64_t a3 = fix(m[3]), a4 = fix(m[4]);
  int64_t xo = fix(m[2] + m[0] * 0.5 + m[1] * 0.5);
  int64_t yo = fix(m[5] + m[3] * 0.5 + m[4] * 0.5);

  // [lo, hi) subrange of [0, n) where 0 <= start + x*step < lim; found by
  // a float estimate tightened at the edges (exact; the estimate is off by
  // at most the float error, fixed by the while loops)
  auto valid_range = [](int64_t start, int64_t step, int64_t lim, int n,
                        int* lo, int* hi) {
    auto ok = [&](long x) {
      const int64_t v = start + (int64_t)x * step;
      return v >= 0 && v < lim;
    };
    long l = 0, r = n;
    if (step != 0) {
      double x0 = (0.0 - (double)start) / (double)step;
      double x1 = ((double)lim - (double)start) / (double)step;
      if (x0 > x1) std::swap(x0, x1);
      l = (long)floor(x0) - 2;
      r = (long)ceil(x1) + 2;
      if (l < 0) l = 0;
      if (l > n) l = n;
      if (r > n) r = n;
      if (r < l) r = l;
    } else if (!ok(0)) {
      l = r = 0;
    }
    while (l < r && !ok(l)) l++;
    while (r > l && !ok(r - 1)) r--;
    *lo = (int)l;
    *hi = (int)r;
  };

  const int64_t xlim = (int64_t)w << 16, ylim = (int64_t)h << 16;
  for (int y = 0; y < h; y++) {
    uint8_t* out = dst + (size_t)y * w * ch;
    int xl, xh, yl, yh;
    valid_range(xo, a0, xlim, w, &xl, &xh);  // over output x: xin in range
    valid_range(yo, a3, ylim, w, &yl, &yh);  // over output x: yin in range
    const int lo = xl > yl ? xl : yl;
    const int hi = xh < yh ? xh : yh;
    if (lo > 0) memset(out, 0, (size_t)lo * ch);
    if (hi < w) memset(out + (size_t)(hi > lo ? hi : lo) * ch, 0,
                       (size_t)(w - (hi > lo ? hi : lo)) * ch);
    int64_t xin = xo + (int64_t)lo * a0, yin = yo + (int64_t)lo * a3;
    if (ch == 3) {
      for (int x = lo; x < hi; x++) {
        const uint8_t* p = src + ((size_t)(yin >> 16) * w + (xin >> 16)) * 3;
        out[x * 3 + 0] = p[0];
        out[x * 3 + 1] = p[1];
        out[x * 3 + 2] = p[2];
        xin += a0;
        yin += a3;
      }
    } else {
      for (int x = lo; x < hi; x++) {
        const uint8_t* p =
            src + ((size_t)(yin >> 16) * w + (xin >> 16)) * ch;
        for (int c = 0; c < ch; c++) out[x * ch + c] = p[c];
        xin += a0;
        yin += a3;
      }
    }
    xo += a1;
    yo += a4;
  }
  return 0;
}

// u8 -> float32 with optional horizontal flip, fusing the pipeline's
// np.asarray(im, f32) / 255 [* 2 - 1] (augment.to_unit_float + the
// optional [-1,1] mapping; reference maps [0,1]->[-1,1] in tf.data,
// data/image_pair_dataloader.py:65-70). Exact same f32 arithmetic.
// src: h x w x ch contiguous; flip mirrors the w axis; pm1 selects
// (v/255)*2-1 over v/255.
int ki_u8_to_f32(const uint8_t* src, float* dst, int w, int h, int ch,
                 int flip, int pm1) {
  if (w <= 0 || h <= 0 || ch <= 0) return 1;
  if (!flip) {
    const size_t n = (size_t)w * h * ch;
    if (pm1) {
      for (size_t i = 0; i < n; i++)
        dst[i] = ((float)src[i] / 255.0f) * 2.0f - 1.0f;
    } else {
      for (size_t i = 0; i < n; i++) dst[i] = (float)src[i] / 255.0f;
    }
    return 0;
  }
  for (int y = 0; y < h; y++) {
    const uint8_t* row = src + (size_t)y * w * ch;
    float* out = dst + (size_t)y * w * ch;
    for (int x = 0; x < w; x++) {
      const uint8_t* p = row + (size_t)(w - 1 - x) * ch;
      for (int c = 0; c < ch; c++)
        out[x * ch + c] = pm1 ? ((float)p[c] / 255.0f) * 2.0f - 1.0f
                              : (float)p[c] / 255.0f;
    }
  }
  return 0;
}

}  // extern "C"
