"""Quantized table storage (the port's copy of ``repro.core.quantize``):
the paper's fixed-point I/O formats and QuantPack entry codes.

Fixed-point (S, W, F) formats — the paper's I/O number representation.  The
hardware consumes/produces fixed-point bit vectors described by tuples
``(S, W, F)``: sign bit, total width, fractional bits (Sec. 6/7.1, Table 3).
The design flow uses this to (a) quantize stored table values the way the BRAM
would hold them and (b) budget the quantization error against ``E_a`` in the
paper's fidelity experiment (``launch/paper.py``).  Paper-faithful accounting,
not the hot path.

Error-budgeted entry quantization for the QuantPack runtime.  The stored breakpoint values of an interval-split table are replaced by int8 /
int16 codes that the kernel dequantizes on read.  The user's bound ``E_a`` is
split ``rho * E_a`` for interpolation (the table is built with the tightened
bound by the existing splitting algorithms) and ``(1-rho) * E_a`` for code
rounding.  Per sub-interval the codes are affine in a **chord residual**: with
ramp slope ``g_j = (v_last - v_first) / n_seg``,

    v_i  ~=  zero_j + g_j * i + scale_j * q_i ,      q_i at b bits

i.e. the code stores only the deviation of ``f`` from the straight line across
the sub-interval.  Since linear interpolation is a convex combination of two
dequantized endpoints, the read-back error is bounded by
``scale_j / 2 <= (1 - rho) * E_a`` and the end-to-end bound still holds.

Wide near-linear sub-intervals have chord residuals far exceeding the rounding
budget at int8; :func:`refine_for_quantization` therefore *re-splits* the
partition at existing breakpoints — interval splitting applied a second time,
for the quantization axis.  ``plan_quant_member`` searches {int8, int16} x
refinement and picks the cheapest feasible encoding.

tests/test_torch_quant_poly.py holds the QuantPack half to the reference's
arrays, tests/test_torch_paper.py the fixed-point formats.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np

from repro_torch import obs

from .functions import FunctionSpec, get as get_function
from .table import TableSpec


@dataclass(frozen=True)
class FixedPointFormat:
    signed: int  # S: 1 if a sign bit is present
    width: int  # W: total bits
    frac: int  # F: fractional bits

    def __post_init__(self):
        if self.signed not in (0, 1):
            raise ValueError("S must be 0 or 1")
        if self.width <= 0 or self.frac < 0:
            raise ValueError("bad (W, F)")
        if self.frac > self.width - self.signed:
            raise ValueError("F exceeds available magnitude bits")

    @property
    def scale(self) -> float:
        return float(2.0 ** self.frac)

    @property
    def resolution(self) -> float:
        return float(2.0 ** (-self.frac))

    @property
    def max_value(self) -> float:
        int_levels = 2 ** (self.width - self.signed)
        return (int_levels - 1) * self.resolution

    @property
    def min_value(self) -> float:
        if not self.signed:
            return 0.0
        return -(2.0 ** (self.width - 1 - self.frac))

    def quantize(self, x: np.ndarray) -> np.ndarray:
        """Round-to-nearest-even quantization with saturation (hardware clamp)."""
        x = np.asarray(x, dtype=np.float64)
        q = np.rint(x * self.scale) / self.scale
        return np.clip(q, self.min_value, self.max_value)

    def quantization_error_bound(self) -> float:
        """Half-ULP rounding bound inside the representable range."""
        return 0.5 * self.resolution

    def to_bits(self, x: np.ndarray) -> np.ndarray:
        """Two's-complement integer codes (for bit-exactness tests)."""
        q = self.quantize(x)
        codes = np.rint(q * self.scale).astype(np.int64)
        if self.signed:
            codes = codes & ((1 << self.width) - 1)
        return codes

    def from_bits(self, codes: np.ndarray) -> np.ndarray:
        codes = np.asarray(codes, dtype=np.int64)
        if self.signed:
            sign_bit = 1 << (self.width - 1)
            codes = np.where(codes & sign_bit, codes - (1 << self.width), codes)
        return codes.astype(np.float64) * self.resolution


# Table 3 I/O formats, keyed by function name: (input fmt, output fmt)
PAPER_FORMATS = {
    "tan": (FixedPointFormat(1, 32, 30), FixedPointFormat(1, 32, 27)),
    "log": (FixedPointFormat(0, 32, 28), FixedPointFormat(1, 32, 29)),
    "exp": (FixedPointFormat(0, 32, 29), FixedPointFormat(0, 32, 24)),
    "tanh": (FixedPointFormat(1, 32, 27), FixedPointFormat(1, 32, 31)),
    "gauss": (FixedPointFormat(1, 32, 28), FixedPointFormat(1, 32, 32 - 1)),  # see note
    "sigmoid": (FixedPointFormat(1, 32, 27), FixedPointFormat(0, 32, 32)),
}
# Note: Table 3 prints (1,32,32) for gauss output — 33 bits of sign+frac in a 32-bit
# word, impossible; the reference uses F=31 and flags the erratum in EXPERIMENTS.md.


# --------------------------------------------------------------------------------------
# QuantPack entry quantization: error-budget split + chord-residual affine codes.
# --------------------------------------------------------------------------------------

QUANT_INT_BITS = (8, 16)  # runtime storage menu (byte widths)
DEFAULT_RHO = 0.9  # interpolation share of E_a; rounding gets the remaining 10 %
DEFAULT_REFINE_CAP = 2048  # max sub-intervals per function after refinement


def quant_rounding_limit(tol: float, bits: int) -> float:
    """Largest per-sub-interval residual range representable at ``bits`` with
    rounding error <= tol: range / (2^b - 1) / 2 <= tol."""
    return 2.0 * tol * (2**bits - 1)


def _sub_slices(spec: TableSpec):
    counts = np.diff(np.concatenate([spec.base, [spec.footprint]]))
    return [(int(spec.base[j]), int(spec.base[j] + counts[j]))
            for j in range(spec.n_intervals)]


def _chord_residual(values: np.ndarray) -> np.ndarray:
    """Deviation of the entries from the straight line through the endpoints."""
    k = len(values)
    if k <= 2:
        return np.zeros(k)
    ramp = values[0] + (values[-1] - values[0]) * np.arange(k) / (k - 1)
    return values - ramp


def chord_residual_ranges(spec: TableSpec) -> np.ndarray:
    """Per-sub-interval chord-residual range — what the affine codes must span."""
    out = np.zeros(spec.n_intervals)
    for j, (s0, s1) in enumerate(_sub_slices(spec)):
        r = _chord_residual(spec.values[s0:s1])
        out[j] = r.max() - r.min()
    return out


@obs.traced("design.verify_refine", "design")
def refine_for_quantization(
    spec: TableSpec, limit: float, cap: int = DEFAULT_REFINE_CAP
) -> TableSpec:
    """Re-split sub-intervals at existing breakpoints until every chord-residual
    range is <= ``limit`` (or every sub-interval is a single segment).

    Cuts land on the segment grid, so both halves keep the parent's ``delta``
    and the Eq. 10 interpolation bound; the evaluated piecewise-linear function
    is unchanged.  Each cut duplicates ONE shared breakpoint entry (the halves
    quantize it under different affine params), i.e. footprint grows by exactly
    the number of cuts, while the residual of the worst half shrinks ~4x
    (residual ~ max|f''| * len^2).  A 1-segment sub-interval has zero residual,
    so the loop always terminates.
    """
    if limit < 0:
        raise ValueError("limit must be non-negative")
    # heap of (-residual_range, j, seg_lo, seg_hi) in parent segment units
    heap = []
    for j, (s0, s1) in enumerate(_sub_slices(spec)):
        r = _chord_residual(spec.values[s0:s1])
        heapq.heappush(heap, (-(r.max() - r.min()), j, 0, s1 - s0 - 1))
    while len(heap) < cap:
        neg, j, a, b = heap[0]
        if -neg <= limit or b - a < 2:
            break
        heapq.heappop(heap)
        s0 = int(spec.base[j])
        m = (a + b) // 2
        for lo_seg, hi_seg in ((a, m), (m, b)):
            r = _chord_residual(spec.values[s0 + lo_seg : s0 + hi_seg + 1])
            heapq.heappush(heap, (-(r.max() - r.min()), j, lo_seg, hi_seg))
    subs = sorted((j, a, b) for _, j, a, b in heap)
    if len(subs) == spec.n_intervals:
        return spec  # nothing to refine
    boundaries, deltas, bases, segs, values = [], [], [], [], []
    acc = 0
    for j, a, b in subs:
        s0 = int(spec.base[j])
        d = float(spec.delta[j])
        p0 = float(spec.boundaries[j])
        # exact parent boundaries where the cut coincides with one
        boundaries.append(p0 if a == 0 else p0 + a * d)
        deltas.append(d)
        bases.append(acc)
        segs.append(b - a)
        values.append(spec.values[s0 + a : s0 + b + 1])
        acc += b - a + 1
    boundaries.append(float(spec.boundaries[-1]))
    return TableSpec(
        name=spec.name,
        lo=spec.lo,
        hi=spec.hi,
        e_a=spec.e_a,
        algorithm=spec.algorithm,
        boundaries=np.asarray(boundaries, dtype=np.float64),
        inv_delta=1.0 / np.asarray(deltas, dtype=np.float64),
        delta=np.asarray(deltas, dtype=np.float64),
        base=np.asarray(bases, dtype=np.int64),
        seg_count=np.asarray(segs, dtype=np.int64),
        values=np.concatenate(values),
    )


@dataclass(frozen=True)
class QuantMember:
    """One function's table with int-coded entries (the QuantPack member artifact).

    Dequantization (the kernel's read path, all f32 at runtime):

        v_i = zero_j + ramp_j * i + scale_j * q_i

    ``q`` holds signed two's-complement codes (int8/int16 storage); ``scale_j``
    is 0 for exactly-linear sub-intervals (the ramp already reproduces them).
    """

    spec: TableSpec  # refined: same piecewise-linear fn, quantization-split
    bits: int  # 8 or 16 — storage width of every code of this member
    rho: float  # interpolation share of e_a the table was built with
    e_a: float  # end-to-end budget (interp + rounding)
    codes: np.ndarray  # (M,) i64 signed codes in [-2^(b-1), 2^(b-1)-1]
    scale: np.ndarray  # (n,) f64 per sub-interval
    zero: np.ndarray  # (n,) f64 per sub-interval
    ramp: np.ndarray  # (n,) f64 per sub-interval chord slope per segment

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def footprint(self) -> int:
        return self.spec.footprint

    @property
    def codes_bytes(self) -> int:
        return self.footprint * (self.bits // 8)

    @property
    def meta_bytes(self) -> int:
        """Selector + dequant metadata, f32 lanes: boundaries (n+1) plus
        inv_delta/base/seg_count/scale/zero/ramp (n each)."""
        n = self.spec.n_intervals
        return (7 * n + 1) * 4

    def dequantize(self) -> np.ndarray:
        """Reconstructed f64 entry values (|v - spec.values| <= scale/2)."""
        out = np.empty(self.footprint)
        for j, (s0, s1) in enumerate(_sub_slices(self.spec)):
            i = np.arange(s1 - s0)
            out[s0:s1] = (self.zero[j] + self.ramp[j] * i
                          + self.scale[j] * self.codes[s0:s1])
        return out

    def eval(self, x: np.ndarray) -> np.ndarray:
        """f64 dequantize-on-read oracle (selector + ramp/scale FMA + lerp)."""
        ts = self.spec
        x = np.asarray(x, dtype=np.float64)
        j = np.clip(np.searchsorted(ts.boundaries, x, side="right") - 1,
                    0, ts.n_intervals - 1)
        p_j = ts.boundaries[j]
        i = np.clip(np.floor((x - p_j) * ts.inv_delta[j]).astype(np.int64),
                    0, ts.seg_count[j] - 1)
        a = ts.base[j] + i
        r = self.zero[j] + self.ramp[j] * i
        y0 = r + self.scale[j] * self.codes[a]
        y1 = r + self.ramp[j] + self.scale[j] * self.codes[a + 1]
        t = np.clip((x - (p_j + i * ts.delta[j])) * ts.inv_delta[j], 0.0, 1.0)
        return y0 + t * (y1 - y0)

    def max_error_on_grid(self, fn: Optional[FunctionSpec] = None,
                          n: int = 100_001) -> float:
        fn = fn or get_function(self.spec.name)
        xs = np.linspace(self.spec.lo, self.spec.hi, n)
        xs = xs[xs < self.spec.hi]
        return float(np.max(np.abs(self.eval(xs) - np.asarray(fn.f(xs)))))


def quantize_spec(spec: TableSpec, tol: float, bits: int, *,
                  rho: float, e_a: float) -> QuantMember:
    """Chord-residual affine quantization of (an already refined) table at
    ``bits``; every sub-interval's residual range must fit the rounding budget."""
    if bits not in QUANT_INT_BITS:
        raise ValueError(f"bits must be one of {QUANT_INT_BITS}")
    levels = 2**bits - 1
    offset = 2 ** (bits - 1)
    n = spec.n_intervals
    codes = np.zeros(spec.footprint, dtype=np.int64)
    scale = np.zeros(n)
    zero = np.zeros(n)
    ramp = np.zeros(n)
    for j, (s0, s1) in enumerate(_sub_slices(spec)):
        v = spec.values[s0:s1]
        n_seg = s1 - s0 - 1
        g = (v[-1] - v[0]) / n_seg
        resid = _chord_residual(v)
        rmin, rmax = float(resid.min()), float(resid.max())
        rng = rmax - rmin
        if rng > quant_rounding_limit(tol, bits) * (1 + 1e-12):
            raise ValueError(
                f"{spec.name!r} sub-interval {j}: residual range {rng:.3e} "
                f"exceeds the int{bits} rounding budget "
                f"{quant_rounding_limit(tol, bits):.3e}; refine first")
        if rng > 0.0:
            s = rng / levels
            q = np.clip(np.rint((resid - rmin) / s), 0, levels) - offset
            z = v[0] + rmin + s * offset
        else:  # exactly linear: the ramp reproduces the entries, codes unused
            s, q, z = 0.0, np.zeros(s1 - s0), v[0]
        codes[s0:s1] = q.astype(np.int64)
        scale[j], zero[j], ramp[j] = s, z, g
    return QuantMember(spec=spec, bits=bits, rho=rho, e_a=e_a, codes=codes,
                       scale=scale, zero=zero, ramp=ramp)


def plan_quant_member(
    fn: FunctionSpec | str,
    e_a: float,
    lo: Optional[float] = None,
    hi: Optional[float] = None,
    algorithm: str = "hierarchical",
    omega: float = 0.3,
    *,
    rho: float = DEFAULT_RHO,
    dtype: str = "auto",
    cap: int = DEFAULT_REFINE_CAP,
    degree: int = 1,
    budget_bytes: Optional[int] = None,
) -> QuantMember:
    """The error-budget splitter: build the table at ``rho * e_a`` with the
    existing splitting algorithms, then pick the cheapest storage width whose
    rounding error fits the remaining ``(1 - rho) * e_a``.

    ``degree``/``budget_bytes`` hand the plan to the unified design-space
    planner (:mod:`repro_torch.core.design`): ``degree > 1`` or a byte budget
    returns the planner's cheapest feasible
    :class:`~repro_torch.core.design.PolyMember` for this function instead of
    a linear :class:`QuantMember` — same memo table, wider key.  ``dtype`` still restricts the storage-width menu there.

    ``dtype='auto'`` tries int8 and int16 (each with its own quantization
    refinement) and keeps the one minimizing ENTRY-STORAGE bytes, tie-broken
    by metadata bytes — the paper's M_F footprint axis.  The objective
    knowingly pays ~28 B of metadata per refinement cut to halve every stored
    code, so at loose budgets an int8 member's TOTAL bytes (codes + meta) can
    exceed int16's; force ``dtype='int16'`` when total on-chip residency is the
    binding constraint.

    Registry-name plans are memoized process-wide (the ``cached_table``
    idiom): the refinement search is the expensive half of building a
    quantized pack, and packs/tests re-request the same members.
    """
    if isinstance(fn, str):
        return _plan_cached(fn, e_a, lo, hi, algorithm, omega, rho, dtype,
                            cap, degree, budget_bytes)
    return _plan(fn, e_a, lo, hi, algorithm, omega, rho, dtype, cap,
                 degree, budget_bytes)


@lru_cache(maxsize=256)
@obs.traced("design.quantize", "design")
def _plan_cached(name, e_a, lo, hi, algorithm, omega, rho, dtype, cap,
                 degree=1, budget_bytes=None):
    return _plan(name, e_a, lo, hi, algorithm, omega, rho, dtype, cap,
                 degree, budget_bytes)


def _plan(fn, e_a, lo, hi, algorithm, omega, rho, dtype, cap,
          degree=1, budget_bytes=None) -> QuantMember:
    if degree != 1 or budget_bytes is not None:
        # the unified planner owns the widened design space (deferred import:
        # design imports this module's budget helpers at module level)
        from . import design

        name = fn if isinstance(fn, str) else fn.name
        dtypes = design.POLY_DTYPES if dtype == "auto" else (
            {"int8": ("int8",), "int16": ("int16",)}[dtype])
        cands = design.enumerate_candidates(
            name, e_a, degrees=(degree,) if degree != 1 else design.POLY_DEGREES,
            dtypes=dtypes, algorithm=algorithm, omega=omega, rho=rho, cap=cap,
            lo=lo, hi=hi)
        best = min(cands, key=design._auto_key)
        if budget_bytes is not None and best.total_bytes > budget_bytes:
            raise ValueError(
                f"member budget {budget_bytes} B infeasible for {name!r}: "
                f"cheapest candidate needs {best.total_bytes} B")
        return best.member
    if not (0.0 < rho < 1.0):
        raise ValueError("rho must be in (0, 1)")
    if dtype not in ("auto", "int8", "int16"):
        raise ValueError(f"dtype must be auto|int8|int16, got {dtype!r}")
    from .flow import cached_table  # deferred, as in the reference

    name = fn if isinstance(fn, str) else fn.name
    base = cached_table(name, rho * e_a, lo, hi, algorithm=algorithm,
                        omega=omega)
    tol = (1.0 - rho) * e_a
    menu = QUANT_INT_BITS if dtype == "auto" else (int(dtype[3:]),)
    candidates = []
    for bits in menu:
        refined = refine_for_quantization(
            base, quant_rounding_limit(tol, bits), cap=cap)
        if chord_residual_ranges(refined).max(initial=0.0) > \
                quant_rounding_limit(tol, bits):
            continue  # cap hit before the width became feasible
        member = quantize_spec(refined, tol, bits, rho=rho, e_a=e_a)
        candidates.append(
            ((member.codes_bytes, member.meta_bytes), bits, member))
    if not candidates:
        raise ValueError(
            f"no feasible quantization for {name!r} at e_a={e_a:g}, rho={rho}, "
            f"dtype={dtype!r} within the {cap}-sub-interval refinement cap; "
            f"lower rho (more rounding budget) or raise the cap")
    candidates.sort(key=lambda c: (c[0], c[1]))
    return candidates[0][2]
