// Per-element bodies of the table lookups (the paper's Fig. 7 pipeline), shared
// by every table kernel of the port: the f32 pack and single table (Row,
// segment, lookup, lookup_grad, tableflash), a range of shards of the sharded
// pack summed in one pass (ShardRows, sharded_sum), the quantized pack
// (QuantRow, quant_lookup) and the polynomial pack (PolyRow, poly_lookup).
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

// Comparator plane: j = min(#(x >= b_k, 1 <= k <= n_scan), n - 1).  A pack
// row scans its +inf padding too (n_scan = n_max), which never counts.
TL_HD int select(float x, const float* bounds, int n_scan, int n) {
  int j = 0;
  for (int k = 1; k <= n_scan; ++k) j += (x >= bounds[k]) ? 1 : 0;
  return j < n - 1 ? j : n - 1;
}

// Cell index i = clip(floor(u), 0, segs - 1); NaN stays NaN.
TL_HD float clamp_cell(float u, float segs) {
  return clamp_hi(clamp_lo(floorf(u), 0.0f), segs - 1.0f);
}

// f32 address -> int, a NaN address (from a NaN input) -> 0, as XLA's
// float-to-int conversion gives; then clamped to [0, m - 1] like mode="clip".
TL_HD int address(float af) { return af >= 0.0f ? static_cast<int>(af) : 0; }
TL_HD int clip_address(int a, int m) { return a < m - 1 ? a : m - 1; }

// The 0/1 indicator of [b_0, b_n), which zeroes a slope outside the domain
// unless extrapolating.  It multiplies, as in the plain versions, so a NaN or
// inf slope stays NaN there (a select would turn it into 0).
TL_HD float inside(float x, const float* bounds, int n) {
  return (x >= bounds[0] && x < bounds[n]) ? 1.0f : 0.0f;
}

// Selector and address, before any values gather: the sub-interval j, u,
// the clamped cell index i and j's reciprocal step.
struct Cell {
  int j;
  float u;
  float i;
  float invd;
};

TL_HD Cell cell(float x, const Row& r) {
  const int j = select(x, r.bounds, r.n_max, r.n_intervals);
  const float p = r.bounds[j];
  const float invd = r.invd[j];
  const float u = (x - p) * invd;
  return Cell{j, u, clamp_cell(u, r.segs[j]), invd};
}

TL_HD Segment segment(float x, const Row& r, const float* values, int m) {
  const Cell c = cell(x, r);
  const int a = address(r.base[c.j] + c.i);
  return Segment{c.u, c.i, c.invd, values[clip_address(a, m)],
                 values[clip_address(a + 1, m)]};
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
// [b_0, b_n) unless extrapolating.
TL_HD float lookup_grad(float x, const Row& r, const float* values, int m,
                        bool extrapolate, float* slope) {
  const Segment s = segment(x, r, values, m);
  float d = (s.y1 - s.y0) * s.invd;
  if (!extrapolate) d = d * inside(x, r.bounds, r.n_intervals);
  *slope = d;
  return lerp(s, extrapolate);
}

// ShardedPack: shards [s_begin, s_end) of one member summed in ONE pass
// (_spack_kernel, _spack_grad_kernel and _sharded_routed_kernel with the
// reference's shard sum fused).  `r` holds the replicated bounds / invd /
// segs rows and, as its base, each sub-interval's base rebased into its
// owner's slice; `sh.owner` the shard that owns each sub-interval (-1 on
// padding), both built once with the pack; `sh.values` the range's padded
// slices of m entries back to back, s_begin's first.  The comparator plane,
// u, i and t run once.  The owner o of j answers if it lies in the range: it
// gathers its pair from its slice (an address past the slice clamped by
// clip_address) and lerps, or takes the slope.  Otherwise the range
// contributes 0: a SELECT, not a product, so an unowned NaN or inf becomes 0
// as jnp.where makes it (the pair is then read from the first slice and
// dropped).
//
// One shard owns each sub-interval, so the reference's sum over the range
// (each shard's contribution rounded to the output dtype, added in shard
// order in that dtype) has a closed form: the shards before o add +0.0 to
// +0.0, o's rounded contribution y lands on +0.0 (y itself, or +0.0 for a
// -0.0 unless o comes first), the shards after o add +0.0.  So the sum is y
// for a range of one shard (left to the store's rounding), round(y) + 0.0 (a
// -0.0 turned +0.0, every other value kept) for a longer range, and +0.0
// where no shard of the range owns j.  kSum: the range is longer than one
// shard (a template flag, so that a range of one carries no rounding);
// `round` rounds to the output dtype.  With `slope` non-null the slope is
// summed the same way.
struct ShardRows {
  const float* owner;
  const float* values;
  int s_begin;
  int n_shards;  // s_end - s_begin
  int m;
};

template <bool kSum, typename Round>
TL_HD float sharded_sum(float x, const Row& r, const ShardRows& sh, bool extrapolate,
                        Round round, float* slope) {
  const Cell c = cell(x, r);
  const float ow = sh.owner[c.j];
  bool own;
  const float* v = sh.values;
  if constexpr (kSum) {
    const int o = static_cast<int>(ow) - sh.s_begin;
    own = o >= 0 && o < sh.n_shards;
    v += (own ? o : 0) * sh.m;
  } else {  // one shard: a float compare, its own slice
    own = ow == static_cast<float>(sh.s_begin);
  }
  const int a = address(r.base[c.j] + c.i);
  const Segment s{c.u, c.i, c.invd, v[clip_address(a, sh.m)],
                  v[clip_address(a + 1, sh.m)]};
  if (slope) {
    float d = (s.y1 - s.y0) * s.invd;
    if (!extrapolate) d = d * inside(x, r.bounds, r.n_intervals);
    d = own ? d : 0.0f;
    if constexpr (kSum) d = round(d) + 0.0f;
    *slope = d;
  }
  const float y = own ? lerp(s, extrapolate) : 0.0f;
  if constexpr (kSum) return round(y) + 0.0f;
  return y;
}

// TableFlash: exp(z) for z <= 0 from the exp_neg member.  The address
// saturates at lo = bounds[0]; the output is exactly 0 where the RAW z < lo.
TL_HD float tableflash(float z, const Row& r, const float* values, int m) {
  const float lo = r.bounds[0];
  const float y = lookup(clamp_lo(z, lo), r, values, m, false);
  return z < lo ? 0.0f : y;
}

// ------------------------------------------------------------------------------
// QuantPack: int8/int16 entry codes, dequantized on read (_quant_kernel).
//
//   r  = zero + ramp * i                (the chord ramp at entry i)
//   y0 = r + scale * c0,  y1 = (r + ramp) + scale * c1
//   y  = y0 + t * (y1 - y0),  slope = (ramp + scale * (c1 - c0)) * invd
//
// One member's ragged row: n + 1 boundaries, n of each other lane; `codes` is
// the member's whole width group (its base addresses are global into it).
struct QuantRow {
  const float* bounds;
  const float* invd;
  const float* base;
  const float* segs;
  const float* scale;
  const float* zero;
  const float* ramp;
  int n;
};

// The value; with `slope` non-null also the slope, from the same pass.
template <typename C>
TL_HD float quant_lookup(float x, const QuantRow& r, const C* codes, int m,
                         bool extrapolate, float* slope) {
  const int j = select(x, r.bounds, r.n, r.n);
  const float p = r.bounds[j];
  const float invd = r.invd[j];
  const float base = r.base[j];
  const float segs = r.segs[j];
  const float scale = r.scale[j];
  const float zero = r.zero[j];
  const float ramp = r.ramp[j];

  const float u = (x - p) * invd;
  const float i = clamp_cell(u, segs);
  const int a = address(base + i);
  const float c0 = static_cast<float>(codes[clip_address(a, m)]);
  const float c1 = static_cast<float>(codes[clip_address(a + 1, m)]);
  const float rr = zero + ramp * i;
  const float y0 = rr + scale * c0;
  const float y1 = (rr + ramp) + scale * c1;
  float t = u - i;
  if (!extrapolate) t = clamp_hi(clamp_lo(t, 0.0f), 1.0f);
  if (slope) {
    float d = (ramp + scale * (c1 - c0)) * invd;
    if (!extrapolate) d = d * inside(x, r.bounds, r.n);
    *slope = d;
  }
  return y0 + t * (y1 - y0);
}

// ------------------------------------------------------------------------------
// PolyPack: degree-d coefficient codes, dequantized per lane, Horner on read
// (_poly_kernel).  Lane l of cell i sits at base + i * (d + 1) + l in the
// member's width group (int8, int16 or raw f32); its dequant params at
// metadata index j * lmax + l:  c_l = (zero + ramp * i) + scale * q.
// y = p(tc) at tc = clip(t, 0, 1); extrapolating, y + p'(tc) * (t - tc);
// slope = p'(tc) * invd.
constexpr int kMaxLanes = 4;  // degree <= 3

struct PolyRow {
  const float* bounds;
  const float* invd;
  const float* base;
  const float* segs;
  const float* zero;  // lane-padded: n * lmax
  const float* ramp;
  const float* scale;
  int n;
  int lmax;
  int degree;
};

// p(t) = (...(c_d t + c_{d-1}) t + ...) t + c_0.  The loops run over the
// fixed kMaxLanes so that a device build keeps cs[] in registers.
TL_HD float horner(const float* cs, int d, float t) {
  float y = 0.0f;
#pragma unroll
  for (int k = kMaxLanes - 1; k >= 0; --k) {
    if (k == d) y = cs[k];
    else if (k < d) y = y * t + cs[k];
  }
  return y;
}

// p'(t) in the derivative Horner form: g = c_d * d, g = g * t + c_k * k.
TL_HD float horner_d1(const float* cs, int d, float t) {
  float g = 0.0f;
#pragma unroll
  for (int k = kMaxLanes - 1; k >= 1; --k) {
    if (k == d) g = cs[k] * static_cast<float>(k);
    else if (k < d) g = g * t + cs[k] * static_cast<float>(k);
  }
  return g;
}

template <typename C>
TL_HD float poly_lookup(float x, const PolyRow& r, const C* codes, int m,
                        bool extrapolate, float* slope) {
  const int j = select(x, r.bounds, r.n, r.n);
  const float p = r.bounds[j];
  const float invd = r.invd[j];
  const float base = r.base[j];
  const float segs = r.segs[j];

  const float u = (x - p) * invd;
  const float i = clamp_cell(u, segs);
  const float stride = static_cast<float>(r.degree + 1);
  float cs[kMaxLanes];
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l) {
    cs[l] = 0.0f;
    if (l <= r.degree) {
      const int k = j * r.lmax + l;
      const float af = base + i * stride + static_cast<float>(l);
      const float q = static_cast<float>(codes[clip_address(address(af), m)]);
      cs[l] = (r.zero[k] + r.ramp[k] * i) + r.scale[k] * q;
    }
  }
  const float t = u - i;
  const float tc = clamp_hi(clamp_lo(t, 0.0f), 1.0f);
  float y = horner(cs, r.degree, tc);
  if (extrapolate || slope) {
    const float g = horner_d1(cs, r.degree, tc);
    if (extrapolate) y = y + g * (t - tc);
    if (slope) {
      float d = g * invd;
      if (!extrapolate) d = d * inside(x, r.bounds, r.n);
      *slope = d;
    }
  }
  return y;
}

}  // namespace tl
