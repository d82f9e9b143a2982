// Argument range reduction for the folded kernels (RangeFold): the folds of
// src/repro_torch/core/range_reduce.py, operation for operation, as plain C++
// on floats and 32-bit integers.
//
//   trig  x = k * (pi/2) + r, r in [-pi/4, pi/4], q = k mod 4: Cody-Waite below
//         |x| = 2048 (pi/2 in two exact 12-bit words and an f32 tail), Payne-Hanek
//         above (the 24-bit mantissa against 192 bits of 2/pi, accumulated mod
//         2^32 at scale 2^29); sflip marks the Payne-Hanek lanes with x < 0.
//   exp   exp(x) = 2^k * exp(r), k = round(x / ln2) clamped to [-252, 252],
//         applied as two exact power-of-two factors.
//   log   x = m * 2^e, m in [sqrt2/2, sqrt2), read bitwise from the float's
//         fields; subnormals normalised by a count-leading-zeros shift.
//
// Bit-parity traps, each handled as the plain version does:
//   * round half to even: rintf (jnp.round, torch.round), never roundf;
//   * jnp.mod(k, 4) and k // 2 are floor operations on signed ints: k & 3 and
//     k >> 1 (arithmetic shift), never % or /;
//   * shifts by 32 or more are undefined: clamped to [0, 31] and the lane
//     zeroed, as _shift_mod32 does;
//   * every product and sum rounds on its own: build with -fmad=false (the
//     k * LO products and the e * LN2 sums are not exact);
//   * clamps are compares, so a NaN passes through them;
//   * no flush of subnormals (no -ftz): log_fold recovers them bitwise.

#pragma once

#include <stdint.h>
#include <string.h>

#include "table_lookup.cuh"

namespace rr {

constexpr float kPio2Hi = 1.5703125f;
constexpr float kPio2Mid = 0.0004837512969970703f;
constexpr float kPio2Lo = 7.54979e-08f;
constexpr float kTwoOverPi = 0.63661975f;
constexpr float kTrigCwMax = 2048.0f;
constexpr float kPhScale = 2.9258362e-09f;
constexpr float kLn2Hi = 0.693145751953125f;
constexpr float kLn2Lo = 1.4286068e-06f;
constexpr float kInvLn2 = 1.442695f;
constexpr float kExpKMax = 252.0f;
constexpr float kSqrt2 = 1.4142135f;

// The four kinds a folded kernel serves (a launch argument).
enum Kind { kSin = 0, kCos = 1, kExp = 2, kLog = 3 };

TL_HD uint32_t bits_of(float f) {
  uint32_t u;
  memcpy(&u, &f, sizeof u);
  return u;
}
TL_HD float float_of(uint32_t u) {
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}

TL_HD float clampf(float v, float lo, float hi) {
  return tl::clamp_hi(tl::clamp_lo(v, lo), hi);
}

// f32 -> int32 of an integral value in range; a NaN (garbage lane, masked by
// the caller's edge handler) becomes 0.
TL_HD int to_int(float v) { return v == v ? static_cast<int>(v) : 0; }

// (v * 2^s) mod 2^32; s < 0 is a truncating right shift; |s| >= 32 gives 0.
TL_HD uint32_t shift_mod32(uint32_t v, int s) {
  if (s <= -32 || s >= 32) return 0u;
  return s >= 0 ? (v << s) : (v >> (-s));
}

// Fixed-point |x| * 2/pi mod 8 at scale 2^29 -> (r, q).  The 192 fractional
// bits of 2/pi are twelve 16-bit limbs; limb j holds bits 2^(-16j-1) ..
// 2^(-16j-16).  Each 12-bit x 16-bit partial product is exact in uint32.
TL_HD float payne_hanek(float ax, int* q) {
  const uint32_t kPhLimbs[12] = {0xA2F9, 0x836E, 0x4E44, 0x1529, 0xFC27, 0x57D1,
                                 0xF534, 0xDDC0, 0xDB62, 0x9599, 0x3C43, 0x9041};
  const uint32_t b = bits_of(ax);
  const int e = static_cast<int>((b >> 23) & 0xFFu);
  const uint32_t m = (b & 0x7FFFFFu) | 0x800000u;
  const uint32_t mh = m >> 12;
  const uint32_t ml = m & 0xFFFu;
  const int p = e - 150;
  uint32_t acc = 0u;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const int s1 = p + 41 - 16 * (j + 1);
    acc += shift_mod32(mh * kPhLimbs[j], s1);
    acc += shift_mod32(ml * kPhLimbs[j], s1 - 12);
  }
  const uint32_t rounded = acc + (1u << 28);
  *q = static_cast<int>((rounded >> 29) & 3u);
  const int fbits = static_cast<int>(rounded & ((1u << 29) - 1u)) - (1 << 28);
  return static_cast<float>(fbits) * kPhScale;
}

struct TrigFold {
  float r;
  int q;
  bool sflip;
};

// `ph`: evaluate Payne-Hanek.  A caller may pass false only where x is not
// big (|x| < 2048), where the selection discards r_ph and q_ph: the folded
// kernels pass false for a warp none of whose lanes is big.
TL_HD TrigFold trig_fold(float x, bool ph) {
  const float ax = fabsf(x);
  const float kf = clampf(rintf(x * kTwoOverPi), -4194304.0f, 4194304.0f);
  const float r_cw = ((x - kf * kPio2Hi) - kf * kPio2Mid) - kf * kPio2Lo;
  const int q_cw = to_int(kf) & 3;
  int q_ph = 0;
  const float r_ph = ph ? payne_hanek(ax, &q_ph) : 0.0f;
  const bool big = ax >= kTrigCwMax;
  return TrigFold{big ? r_ph : r_cw, big ? q_ph : q_cw, big && x < 0.0f};
}

TL_HD TrigFold trig_fold(float x) { return trig_fold(x, true); }

// [ys, yc, -ys, -yc][q] for sin, [yc, -ys, -yc, ys][q] for cos.
TL_HD float quadrant_select(int kind, float ys, float yc, int q) {
  if (kind == kSin) return q == 0 ? ys : (q == 1 ? yc : (q == 2 ? -ys : -yc));
  return q == 0 ? yc : (q == 1 ? -ys : (q == 2 ? -yc : ys));
}

TL_HD float trig_reconstruct(int kind, float ys, float yc, const TrigFold& f) {
  const float y = quadrant_select(kind, ys, yc, f.q);
  return (kind == kSin && f.sflip) ? -y : y;
}

TL_HD float trig_slope_reconstruct(int kind, float ds, float dc, const TrigFold& f) {
  const float s = quadrant_select(kind, ds, dc, f.q);
  return (kind == kCos && f.sflip) ? -s : s;
}

TL_HD float trig_edges(float x, float y) { return isfinite(x) ? y : NAN; }

struct ExpFold {
  float r;
  int k;
};

TL_HD ExpFold exp_fold(float x) {
  const float kf = clampf(rintf(x * kInvLn2), -kExpKMax, kExpKMax);
  return ExpFold{(x - kf * kLn2Hi) - kf * kLn2Lo, to_int(kf)};
}

// 2^k for k in [-126, 127] from the exponent field.
TL_HD float pow2(int k) {
  return float_of(static_cast<uint32_t>(k + 127) << 23);
}

TL_HD float exp_reconstruct(float ycore, int k) {
  const int k1 = k >> 1;  // floor division (arithmetic shift)
  const int k2 = k - k1;
  return (ycore * pow2(k1)) * pow2(k2);
}

TL_HD float exp_edges(float x, float y) {
  if (x == INFINITY) return INFINITY;
  if (x == -INFINITY) return 0.0f;
  return isnan(x) ? NAN : y;
}

struct LogFold {
  float m;
  float e;
};

TL_HD int clz32(uint32_t v) {
#ifdef __CUDA_ARCH__
  return __clz(static_cast<int>(v));
#else
  return v == 0u ? 32 : __builtin_clz(v);
#endif
}

TL_HD LogFold log_fold(float x) {
  const uint32_t b = bits_of(x);
  uint32_t mant = b & 0x7FFFFFu;
  const int field = static_cast<int>((b >> 23) & 0xFFu);
  const bool is_sub = field == 0 && mant != 0u;
  int shift = clz32(mant) - 8;
  shift = shift < 0 ? 0 : (shift > 31 ? 31 : shift);
  if (is_sub) mant = mant << shift;
  int e = is_sub ? -126 - shift : field - 127;
  float m = float_of((mant & 0x7FFFFFu) | (127u << 23));  // [1, 2)
  if (m >= kSqrt2) {
    m = m * 0.5f;  // exact halving into [sqrt2/2, sqrt2)
    e += 1;
  }
  return LogFold{m, static_cast<float>(e)};
}

TL_HD float log_reconstruct(float ycore, float e) {
  return e * kLn2Hi + (ycore + e * kLn2Lo);
}

// Decided bitwise: log(+-0) = -inf, log(x < 0) = NaN, log(+-inf) = inf,
// log(NaN) = NaN.
TL_HD float log_edges(float x, float y) {
  const uint32_t bits = bits_of(x);
  const uint32_t mag = bits & 0x7FFFFFFFu;
  const bool is_zero = mag == 0u;
  if (mag > 0x7F800000u) return NAN;
  if (mag == 0x7F800000u) return INFINITY;
  if ((bits >> 31) != 0u && !is_zero) return NAN;
  return is_zero ? -INFINITY : y;
}

// The log slope's mask: 1 on positive normal finite x, else 0, decided
// bitwise (subnormal lanes get slope 0 like the other edge lanes).
TL_HD float log_slope_mask(float x) {
  const uint32_t bits = bits_of(x);
  const uint32_t field = (bits >> 23) & 0xFFu;
  return ((bits >> 31) == 0u && field >= 1u && field <= 254u) ? 1.0f : 0.0f;
}

// One element of the folded kernels (_folded_kernel, _folded_grad_kernel):
// the fold, one core lookup (exp, log) or two (sin, cos: rows a and b, the
// sin_core and cos_core members), never extrapolating, then the
// reconstruction and the edge handler.  With `slope` non-null also the
// chain-ruled slope from the same selector passes: the core slopes through
// the quadrant cycle (trig, 0 on non-finite x), through 2^k (exp, 0 where x
// or the rescaled slope is not finite), or times m / x (log, 0 off the
// positive normal numbers).  `ph` as trig_fold's.
TL_HD float folded(int kind, float x, const tl::Row& a, const tl::Row& b,
                   const float* values, int m, float* slope, bool ph = true) {
  if (kind == kSin || kind == kCos) {
    const TrigFold f = trig_fold(x, ph);
    float ys, yc;
    if (slope) {
      float ds, dc;
      ys = tl::lookup_grad(f.r, a, values, m, false, &ds);
      yc = tl::lookup_grad(f.r, b, values, m, false, &dc);
      *slope = isfinite(x) ? trig_slope_reconstruct(kind, ds, dc, f) : 0.0f;
    } else {
      ys = tl::lookup(f.r, a, values, m, false);
      yc = tl::lookup(f.r, b, values, m, false);
    }
    return trig_edges(x, trig_reconstruct(kind, ys, yc, f));
  }
  if (kind == kExp) {
    const ExpFold f = exp_fold(x);
    float yc;
    if (slope) {
      float dc;
      yc = tl::lookup_grad(f.r, a, values, m, false, &dc);
      const float s = exp_reconstruct(dc, f.k);
      *slope = (isfinite(x) && isfinite(s)) ? s : 0.0f;
    } else {
      yc = tl::lookup(f.r, a, values, m, false);
    }
    return exp_edges(x, exp_reconstruct(yc, f.k));
  }
  const LogFold f = log_fold(x);
  float yc;
  if (slope) {
    float dc;
    yc = tl::lookup_grad(f.m, a, values, m, false, &dc);
    const float mask = log_slope_mask(x);
    const float safe_x = x * mask + (1.0f - mask);
    *slope = (mask * dc) * (f.m / safe_x);
  } else {
    yc = tl::lookup(f.m, a, values, m, false);
  }
  return log_edges(x, log_reconstruct(yc, f.e));
}

}  // namespace rr
