"""Argument range reduction, in PyTorch: fold unbounded domains onto the small
canonical intervals of the pack's core members (the port's copy of the JAX
package's ``core/range_reduce.py``, whose folds are written in ``jax.numpy``).

Three folds, each with its reconstruction and its edge handler:

* **trig** (``trig_fold``): ``x = k*(pi/2) + r``, ``r in [-pi/4, pi/4]``, the
  quadrant ``q = k mod 4`` selecting sign and swap between ``sin_core`` and
  ``cos_core``.  Cody-Waite (``pi/2`` in two exact 12-bit words and an f32
  tail) below ``|x| = 2048``; Payne-Hanek above (the 24-bit mantissa against
  192 bits of ``2/pi`` in twelve 16-bit limbs, accumulated mod ``2^32`` at
  scale ``2^29``).
* **exp** (``exp_fold``): ``exp(x) = 2^k * exp(r)``, ``k = round(x/ln2)``
  clamped to ``[-252, 252]``, ``r`` from a two-word Cody-Waite ``ln2``; ``2^k``
  is applied as two exact power-of-two factors.
* **log** (``log_fold``): ``x = m * 2^e``, ``m in [sqrt2/2, sqrt2)``, read
  bitwise from the float's fields (subnormals normalised by a
  count-leading-zeros shift); ``log(x) = e*ln2 + log_core(m)``.

Every function is the reference's op for op, one rounding per operation, so
the port's folded lookups are bit-identical to the JAX package's eager ones.
The reference computes the Payne-Hanek accumulator and the float fields in
uint32; PyTorch's uint32 coverage is thin, so here they are int64 tensors
holding the uint32 value, masked with ``& 0xFFFFFFFF`` after every add and
shift (a 28-bit product shifted left by up to 31 still fits in int64).
``jax.lax.clz`` has no PyTorch counterpart: a 23-bit mantissa converts to f32
exactly, so its leading-zero count is ``32 - frexp(mant).exponent``.
The CUDA kernels carry the same folds in ``csrc/range_reduce.cuh``.
"""

from __future__ import annotations

import numpy as np
import torch

# pi/2 = PIO2_HI + PIO2_MID + PIO2_LO + O(2e-15); HI/MID carry 12 significant
# bits so k*HI and k*MID are exact f32 products for |k| <= 2^12.
PIO2_HI = np.float32(1.5703125)
PIO2_MID = np.float32(0.0004837512969970703)
PIO2_LO = np.float32(7.54979e-08)
TWO_OVER_PI = np.float32(0.63661975)
# Cody-Waite k stays exact below this; Payne-Hanek takes over above.
TRIG_CW_MAX = 2048.0
# r = fraction * (pi/2) at the 2^-29 fixed-point scale kept by Payne-Hanek.
PH_SCALE = np.float32(2.9258362e-09)
# 192 fractional bits of 2/pi as twelve 16-bit limbs: limb j holds bits
# 2^(-16j-1) .. 2^(-16j-16).
PH_LIMBS = (0xA2F9, 0x836E, 0x4E44, 0x1529, 0xFC27, 0x57D1,
            0xF534, 0xDDC0, 0xDB62, 0x9599, 0x3C43, 0x9041)

# ln2 = LN2_HI + LN2_LO + O(6e-14); HI carries 16 bits so k*HI is exact for |k| <= 2^8.
LN2_HI = np.float32(0.693145751953125)
LN2_LO = np.float32(1.4286068e-06)
INV_LN2 = np.float32(1.442695)
# |k| clamp for exp: k1 = k//2 and k2 = k-k1 stay valid normal exponents.
EXP_K_MAX = 252

SQRT2 = np.float32(1.4142135)

# Canonical core intervals (guard bands over pi/4 and ln2/2 absorb the
# k-rounding half-integer cases).
SIN_CORE_INTERVAL = (-0.79, 0.79)
COS_CORE_INTERVAL = (-0.79, 0.79)
EXP_CORE_INTERVAL = (-0.36, 0.36)
LOG_CORE_INTERVAL = (0.70, 1.42)

_MASK32 = 0xFFFFFFFF


def _f(c) -> float:
    """An f32 constant as the Python float of the same value (exact)."""
    return float(np.float32(c))


def u32_bits(xf: torch.Tensor) -> torch.Tensor:
    """The f32 bit pattern of ``xf`` as a uint32 value in an int64 tensor."""
    return xf.contiguous().view(torch.int32).to(torch.int64) & _MASK32


def f32_from_bits(v: torch.Tensor) -> torch.Tensor:
    """The f32 whose bit pattern is the low 32 bits of int64 ``v``."""
    v = v & _MASK32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32).view(
        torch.float32)


# --------------------------------------------------------------------------------------
# trig: x -> (r, q, sflip) with sin(x) = (-1)^sflip * [sin, cos, -sin, -cos][q](r)
# --------------------------------------------------------------------------------------


def _shift_mod32(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``(v * 2^s) mod 2^32`` for uint32 ``v`` and integer ``s`` (negative: a
    truncating right shift).  Shifts are clamped to [0, 31] and the lanes
    whose shift is out of range are zero, as in the reference (any uint32
    times 2^(>=32) is 0 mod 2^32, and v >> (>=32) is 0)."""
    sl = torch.clamp(s, 0, 31)
    sr = torch.clamp(-s, 0, 31)
    out = torch.where(s >= 0, (v << sl) & _MASK32, v >> sr)
    return torch.where((s > -32) & (s < 32), out, 0)


def _payne_hanek(ax: torch.Tensor):
    """Fixed-point ``|x| * 2/pi`` mod 8 at scale ``2^29`` -> (r, q)."""
    b = u32_bits(ax.to(torch.float32))
    e = (b >> 23) & 0xFF
    m = (b & 0x7FFFFF) | 0x800000  # implicit leading bit (ax >= 2048 is normal)
    mh = m >> 12  # high 12 mantissa bits
    ml = m & 0xFFF  # low 12 mantissa bits
    p = e - 150  # ax = m * 2^p with integer m in [2^23, 2^24)
    acc = torch.zeros_like(b)
    for j, limb in enumerate(PH_LIMBS):
        s1 = p + 41 - 16 * (j + 1)  # mh*limb carries an extra 2^12
        acc = (acc + _shift_mod32(mh * limb, s1)) & _MASK32
        acc = (acc + _shift_mod32(ml * limb, s1 - 12)) & _MASK32
    rounded = (acc + (1 << 28)) & _MASK32
    q = ((rounded >> 29) & 3).to(torch.int32)
    fbits = ((rounded & ((1 << 29) - 1)) - (1 << 28)).to(torch.int32)
    r = fbits.to(torch.float32) * _f(PH_SCALE)
    return r, q


def trig_fold(x: torch.Tensor):
    """Fold f32 ``x`` for sin/cos: ``(r, q, sflip)``.

    ``q`` is ``k mod 4`` of ``k = round(x * 2/pi)`` (int32), and ``sflip``
    marks the Payne-Hanek lanes with ``x < 0`` (folded through ``|x|``), whose
    SIN is negated on reconstruction.  ``|x| < pi/4`` folds to itself bitwise.
    Non-finite inputs give garbage lanes the caller masks with ``isfinite``.
    """
    xf = x.to(torch.float32)
    ax = torch.abs(xf)
    kf = torch.round(xf * _f(TWO_OVER_PI))
    kf = torch.clamp(kf, -4194304.0, 4194304.0)  # keep the int32 cast defined
    r_cw = ((xf - kf * _f(PIO2_HI)) - kf * _f(PIO2_MID)) - kf * _f(PIO2_LO)
    q_cw = kf.to(torch.int32) & 3  # the floor modulo of jnp.mod(k, 4)
    r_ph, q_ph = _payne_hanek(ax)
    big = ax >= TRIG_CW_MAX
    r = torch.where(big, r_ph, r_cw)
    q = torch.where(big, q_ph, q_cw)
    sflip = big & (xf < 0)
    return r, q, sflip


def quadrant_select(kind: str, ys, yc, q):
    """``[ys, yc, -ys, -yc][q]`` for sin, ``[yc, -ys, -yc, ys][q]`` for cos;
    also the derivative pattern when fed core slopes."""
    if kind == "sin":
        return torch.where(q == 0, ys, torch.where(q == 1, yc, torch.where(
            q == 2, -ys, -yc)))
    if kind == "cos":
        return torch.where(q == 0, yc, torch.where(q == 1, -ys, torch.where(
            q == 2, -yc, ys)))
    raise ValueError(f"quadrant_select kind must be sin/cos, got {kind!r}")


def trig_reconstruct(kind: str, ys, yc, q, sflip):
    """sin(x) or cos(x) from the core values at r and the fold bookkeeping."""
    y = quadrant_select(kind, ys, yc, q)
    if kind == "sin":
        y = torch.where(sflip, -y, y)
    return y


def trig_slope_reconstruct(kind: str, ds, dc, q, sflip):
    """Chain-rule slope of the folded trig surrogate from the CORE slopes at
    r: the values' select cycle, and on the Payne-Hanek ``|x|`` lanes cos
    picks up ``d|x|/dx = -1`` (sin's two negations cancel)."""
    sl = quadrant_select(kind, ds, dc, q)
    if kind == "cos":
        sl = torch.where(sflip, -sl, sl)
    return sl


def trig_edges(xf, y):
    """Non-finite trig inputs (inf, -inf, NaN) all map to NaN."""
    return torch.where(torch.isfinite(xf), y, float("nan"))


# --------------------------------------------------------------------------------------
# exp: exp(x) = 2^k * exp(r), r in [-ln2/2, ln2/2]
# --------------------------------------------------------------------------------------


def exp_fold(x: torch.Tensor):
    """Fold f32 ``x`` for exp: ``(r, k)`` with ``exp(x) = 2^k * exp(r)``, k
    int32 clamped to ``[-252, 252]`` (beyond it the core's edge clamp
    saturates the result to 0 / inf).  ``|x| < ln2/2`` folds to itself."""
    xf = x.to(torch.float32)
    kf = torch.round(xf * _f(INV_LN2))
    kf = torch.clamp(kf, -float(EXP_K_MAX), float(EXP_K_MAX))
    r = (xf - kf * _f(LN2_HI)) - kf * _f(LN2_LO)
    return r, kf.to(torch.int32)


def pow2(k: torch.Tensor) -> torch.Tensor:
    """``2^k`` for int ``k in [-126, 127]`` straight from the exponent field."""
    return f32_from_bits((k.to(torch.int64) + 127) << 23)


def exp_reconstruct(ycore, k):
    """``ycore * 2^k`` as two exact power-of-two factors (``k // 2`` is a
    floor division, as in the reference), so gradual underflow and
    overflow-to-inf come out right."""
    k1 = torch.div(k, 2, rounding_mode="floor")
    k2 = k - k1
    return (ycore * pow2(k1)) * pow2(k2)


def exp_edges(xf, y):
    """exp's non-finite edges: NaN -> NaN, +inf -> inf, -inf -> 0."""
    y = torch.where(xf == float("inf"), float("inf"), y)
    y = torch.where(xf == float("-inf"), 0.0, y)
    return torch.where(torch.isnan(xf), float("nan"), y)


# --------------------------------------------------------------------------------------
# log: x = m * 2^e, m in [sqrt2/2, sqrt2)
# --------------------------------------------------------------------------------------


def log_fold(x: torch.Tensor):
    """Fold f32 ``x`` for log: ``(m, e)`` with ``x = m * 2^e``, ``m in
    [sqrt2/2, sqrt2)`` and ``e`` in f32.  Subnormals are normalised bitwise;
    non-positive and non-finite lanes give garbage ``log_edges`` pins."""
    xf = x.to(torch.float32)
    b = u32_bits(xf)
    mant = b & 0x7FFFFF
    field = (b >> 23) & 0xFF
    is_sub = (field == 0) & (mant != 0)
    # clz(mant) in 32 bits: mant < 2^23 is exact in f32, frexp's exponent is
    # its bit length (0 for mant = 0, so clz = 32 as jax.lax.clz gives)
    clz = 32 - torch.frexp(mant.to(torch.float32)).exponent.to(torch.int64)
    shift = torch.clamp(clz - 8, 0, 31)
    mant = torch.where(is_sub, (mant << shift) & _MASK32, mant)
    e = torch.where(is_sub, -126 - shift, field - 127)
    m = f32_from_bits((mant & 0x7FFFFF) | (127 << 23))  # [1, 2)
    half = m >= _f(SQRT2)
    m = torch.where(half, m * 0.5, m)  # exact halving into [sqrt2/2, sqrt2)
    e = e + half.to(torch.int64)
    return m, e.to(torch.float32)


def log_reconstruct(ycore, e):
    """``e*ln2 + log_core(m)`` with the split ``ln2`` summed small terms first."""
    return e * _f(LN2_HI) + (ycore + e * _f(LN2_LO))


def log_edges(xf, y):
    """log's edges, decided bitwise as in the reference: log(+-0) = -inf,
    log(x < 0) = NaN, log(+-inf) = inf, log(NaN) = NaN."""
    bits = u32_bits(xf)
    mag = bits & 0x7FFFFFFF
    is_zero = mag == 0
    is_neg = (bits >> 31) != 0
    y = torch.where(is_zero, float("-inf"), y)
    y = torch.where(is_neg & ~is_zero, float("nan"), y)
    y = torch.where(mag == 0x7F800000, float("inf"), y)
    return torch.where(mag > 0x7F800000, float("nan"), y)
