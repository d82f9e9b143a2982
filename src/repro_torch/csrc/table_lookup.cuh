// Per-element body of the table lookup (the paper's Fig. 7 pipeline), shared
// by every table kernel of the port.
//
//   interval selector  j = min(#(x >= b_m, m >= 1), n - 1)   (comparator plane)
//   parameter fetch    p = b_j, invd_j, base_j, segs_j       (four gathers)
//   address            i = clip(floor((x - p) * invd), 0, segs - 1)
//   BRAM read          y0 = v[base + i], y1 = v[base + i + 1] (clamped to [0, M-1])
//   interpolation      y0 + t * (y1 - y0), t = (x - p) * invd - i, t clamped to
//                      [0, 1] unless extrapolating
//
// Every operation rounds to f32 on its own.  Build with -fmad=false: the plain
// PyTorch version (repro_torch.approx.torch_table.lookup_rows) runs one op per
// rounding, and an FMA-contracted lerp differs from it in about 7% of points by
// 1 ULP.  Clamps are written as compares so that a NaN passes through them as
// it does through torch.clamp (fminf/fmaxf would drop it).
//
// Host/device: the body is plain C++ on floats, so a host compiler can build it
// for a check of the arithmetic away from the card.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define TL_HD __host__ __device__ __forceinline__
#else
#define TL_HD inline
#endif

namespace tl {

// One member row of a pack (or a single table): bounds has n_max + 1 entries
// (right-padded with +inf), invd/base/segs n_max each (base and segs hold
// exact integers in f32).
struct Row {
  const float* bounds;
  const float* invd;
  const float* base;
  const float* segs;
  int n_max;
  int n_intervals;
};

TL_HD float clamp_lo(float v, float lo) { return v < lo ? lo : v; }
TL_HD float clamp_hi(float v, float hi) { return v > hi ? hi : v; }

// Selector, address and pair gather: what the value and the slope share.
struct Segment {
  float u;     // (x - p) * invd
  float i;     // clamped cell index
  float invd;  // the selected sub-interval's reciprocal step
  float y0, y1;
};

TL_HD Segment segment(float x, const Row& r, const float* values, int m) {
  int j = 0;
  for (int k = 1; k <= r.n_max; ++k) j += (x >= r.bounds[k]) ? 1 : 0;
  j = j < r.n_intervals - 1 ? j : r.n_intervals - 1;
  const float p = r.bounds[j];
  const float invd = r.invd[j];
  const float base = r.base[j];
  const float segs = r.segs[j];

  const float u = (x - p) * invd;
  const float i = clamp_hi(clamp_lo(floorf(u), 0.0f), segs - 1.0f);
  const float af = base + i;
  const int a = af >= 0.0f ? static_cast<int>(af) : 0;  // NaN -> 0
  const int a0 = a < m - 1 ? a : m - 1;
  const int a1 = a + 1 < m - 1 ? a + 1 : m - 1;
  return Segment{u, i, invd, values[a0], values[a1]};
}

TL_HD float lerp(const Segment& s, bool extrapolate) {
  float t = s.u - s.i;
  if (!extrapolate) t = clamp_hi(clamp_lo(t, 0.0f), 1.0f);
  return s.y0 + t * (s.y1 - s.y0);
}

TL_HD float lookup(float x, const Row& r, const float* values, int m,
                   bool extrapolate) {
  return lerp(segment(x, r, values, m), extrapolate);
}

// Value and slope from one selector pass (the body of _pack_grad_kernel and
// _table_grad_kernel).  The slope is (y1 - y0) * invd, zeroed outside
// [b_0, b_n) unless extrapolating.  The zeroing is a multiply by the 0/1
// indicator, as in the plain version, so a NaN or inf slope stays NaN there
// (a select would turn it into 0).
TL_HD float lookup_grad(float x, const Row& r, const float* values, int m,
                        bool extrapolate, float* slope) {
  const Segment s = segment(x, r, values, m);
  float d = (s.y1 - s.y0) * s.invd;
  if (!extrapolate) {
    const float inside =
        (x >= r.bounds[0] && x < r.bounds[r.n_intervals]) ? 1.0f : 0.0f;
    d = d * inside;
  }
  *slope = d;
  return lerp(s, extrapolate);
}

// TableFlash: exp(z) for z <= 0 from the exp_neg member.  The address
// saturates at lo = bounds[0]; the output is exactly 0 where the RAW z < lo.
TL_HD float tableflash(float z, const Row& r, const float* values, int m) {
  const float lo = r.bounds[0];
  const float y = lookup(clamp_lo(z, lo), r, values, m, false);
  return z < lo ? 0.0f : y;
}

}  // namespace tl
