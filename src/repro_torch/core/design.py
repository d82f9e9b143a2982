"""Unified design-space planner: degree x spacing x storage width in one search
(the port's copy of ``repro.core.design``).

The paper's flow fixes interpolation at degree 1 (a chord per segment) and
leaves storage width to a separate pass (``plan_quant_member``).  This module
turns both into axes of ONE search, following the polynomial-interpolation
design-space generation of the Intel paper (PAPERS.md, arXiv 2205.09504):

* **Degree** d in {1, 2, 3}: each uniform cell of width ``h`` stores the d+1
  coefficients of the interpolating polynomial through d+1 equispaced nodes
  (node spacing ``s = h / d``).  The classic remainder bound generalizes the
  paper's Eq. 10: with ``C_d = max_{t in [0, d]} |prod_i (t - i)|``,

      E  <=  max|f^(d+1)| / (d+1)!  *  s^(d+1)  *  C_d

  Inverting for the admissible cell width (``poly_cell_width``) recovers the
  paper's Eq. 11 exactly at d=1 (C_1 = 1/4  =>  h = sqrt(8 E_a / max|f''|)).

* **Spacing**: the existing splitting algorithms run unchanged — the degree-d
  remainder test is injected through :class:`_RemainderOracle`, which presents
  the generalized bound behind the ``max|f''|`` interface the splitters already
  consume.  A shared :func:`deriv_probe` cache holds one derivative range-max
  oracle per (function, interval, order), so enumerating a whole candidate
  menu never rebuilds a ``SecondDerivMax``-style grid.

* **Width**: f32, int16 or int8 coefficient storage.  Integer widths reuse the
  QuantPack chord-residual idea per *lane*: across the cells of a sub-interval
  the lane-l coefficients are coded affinely, ``c_l(i) = zero + ramp*i +
  scale*q_i``.  Since ``|p(t) - p~(t)| <= sum_l |dc_l|`` for t in [0, 1], the
  rounding budget ``(1 - rho) * E_a`` is split evenly over the d+1 lanes.
  Infeasible sub-intervals are bisected at cell boundaries (the polynomial
  pieces are untouched, so — unlike the linear QuantPack — refinement grows
  only metadata, never the stored codes).

Because the d>=2 cell-width bound leans on *numeric* third/fourth derivatives
(finite differences of the registered ``d2f``), every member build runs a
verify-and-refine loop: cell counts are increased until a dense f64 probe grid
meets the interpolation budget, so the artifact guarantee never depends on the
finite-difference estimate being tight.

On top sit the planner entry points: :func:`enumerate_candidates` builds the
feasible (degree, dtype) menu for one function, :func:`pareto_front` filters it
to the (entries, bytes) non-dominated set, and :func:`plan` picks one candidate
per function — cheapest overall when no budget is given, or
greedy-downgrade-from-preferred under ``budget_bytes`` (start every function at
its lowest-degree/widest-width candidate, repeatedly switch the function with
the largest byte saving to its cheapest candidate until the pack fits).

The pack-level residency report, the reference's ``PackPlan.vmem`` (TPU
VMEM), is ``PackPlan.smem``: the planned pack's staging image in a block's
shared memory on the card (``PolyPackLayout.smem``).  For a single table,
``core.bram.smem_cost`` gives the table kernels' staging image.  tests/test_torch_quant_poly.py holds this copy to the reference's
candidates and plans.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs

from .bram import SMEM_BYTES, SmemPackCost
from .functions import FunctionSpec, get as get_function
from .packing import poly_pack_layout
from .quantize import DEFAULT_REFINE_CAP, DEFAULT_RHO, quant_rounding_limit
from .spacing import SecondDerivMax
from .splitting import split

POLY_DEGREES = (1, 2, 3)
POLY_DTYPES = ("f32", "int16", "int8")  # widest-first = the preference order
DTYPE_BITS = {"f32": 32, "int16": 16, "int8": 8}

_FD_SAFETY = 1.05  # headroom on finite-difference derivative estimates
_PROBE_GRID_N = 8193


@lru_cache(maxsize=8)
def interp_error_const(degree: int) -> float:
    """C_d = max over [0, d] of |prod_{i=0..d} (t - i)| (node-polynomial max).

    C_1 = 1/4 makes the degree-1 remainder bound coincide with Eq. 10.
    """
    if degree < 1:
        raise ValueError("degree must be >= 1")
    t = np.linspace(0.0, float(degree), 16385)
    w = np.prod(t[:, None] - np.arange(degree + 1)[None, :], axis=1)
    return float(np.max(np.abs(w)))


def poly_cell_width(max_deriv: float, e_a: float, degree: int) -> float:
    """Largest admissible uniform cell width for a degree-``degree`` fit.

    Solves the remainder bound for ``h = d * s``; ``inf`` when the driving
    derivative vanishes (one cell spans the interval).  At degree 1 this is
    exactly Eq. 11: sqrt(8 E_a / max|f''|).
    """
    if e_a <= 0:
        raise ValueError("E_a must be positive")
    if max_deriv <= 0.0:
        return math.inf
    s = (math.factorial(degree + 1) * e_a
         / (interp_error_const(degree) * max_deriv)) ** (1.0 / (degree + 1))
    return degree * s


class DerivProbe:
    """Range-max oracle for |f^(order)|, order in {3, 4}, via finite
    differences of the registered analytic ``d2f`` on a dense grid.

    The estimate is biased up by ``_FD_SAFETY``; correctness never rests on it
    (``build_poly_member`` verifies every sub-interval on a dense grid and
    refines), it only has to be a good *sizing* guess.
    """

    def __init__(self, spec: FunctionSpec, lo: float, hi: float, order: int,
                 grid_n: int = _PROBE_GRID_N):
        if hi <= lo:
            raise ValueError(f"empty base interval [{lo}, {hi})")
        if order not in (3, 4):
            raise ValueError("DerivProbe handles orders 3 and 4")
        self.lo, self.hi = float(lo), float(hi)
        xs = np.linspace(self.lo, self.hi, grid_n)
        step = (self.hi - self.lo) / (grid_n - 1)
        vals = np.asarray(spec.d2f(xs), dtype=np.float64)
        for _ in range(order - 2):
            vals = np.gradient(vals, step)
        vals = np.abs(vals) * _FD_SAFETY
        if not np.all(np.isfinite(vals)):
            raise ValueError(
                f"|f^({order})| estimate not finite on [{lo}, {hi}) for "
                f"{spec.name!r}")
        self._vals = vals
        self._step = step
        self._n = grid_n

    def query(self, a: float, b: float) -> float:
        """max |f^(order)| over [a, b], widened to the surrounding samples."""
        if b <= a:
            raise ValueError(f"empty interval [{a}, {b})")
        a = max(a, self.lo)
        b = min(b, self.hi)
        i0 = max(0, int(math.floor((a - self.lo) / self._step)))
        i1 = min(self._n - 1, int(math.ceil((b - self.lo) / self._step)))
        if i1 <= i0:
            i1 = min(self._n - 1, i0 + 1)
        return float(np.max(self._vals[i0:i1 + 1]))


@lru_cache(maxsize=256)
def deriv_probe(name: str, lo: float, hi: float, order: int):
    """The shared derivative-probe cache (one grid per (fn, interval, order)).

    Order 2 returns the exact-endpoint :class:`SecondDerivMax`; orders 3/4
    return finite-difference :class:`DerivProbe` instances.  Every candidate
    the planner enumerates — all degrees, all widths — hits this cache, so a
    12-member pack builds each grid once.
    """
    spec = get_function(name)
    if order == 2:
        return SecondDerivMax(spec, lo, hi)
    return DerivProbe(spec, lo, hi, order)


class _RemainderOracle:
    """Adapter that speaks the splitters' ``max|f''|`` protocol but answers
    with the degree-d remainder bound.

    ``delta_for`` turns a queried max into ``sqrt(8 E_a / m)``; reporting
    ``m = 8 E_a / h_d^2`` (h_d the admissible degree-d cell width) makes the
    unmodified splitting algorithms partition by the generalized error test.
    """

    def __init__(self, probe, e_a: float, degree: int):
        self._probe = probe
        self._e_a = float(e_a)
        self._degree = int(degree)

    def max_abs_d2(self, lo: float, hi: float) -> float:
        h = poly_cell_width(self._probe.query(lo, hi), self._e_a, self._degree)
        if not math.isfinite(h):
            return 0.0  # delta_for then uses the whole interval
        return 8.0 * self._e_a / (h * h)

    query = max_abs_d2


@lru_cache(maxsize=8)
def _vandermonde_inv(degree: int) -> np.ndarray:
    """Inverse Vandermonde on the equispaced nodes t = k/d, k = 0..d.

    ``c = Vinv @ y`` are the monomial coefficients of the interpolating
    polynomial on the cell parameter t in [0, 1]; d=1 reduces to the chord
    (c0 = y0, c1 = y1 - y0).
    """
    k = np.arange(degree + 1, dtype=np.float64) / degree
    v = k[:, None] ** np.arange(degree + 1, dtype=np.float64)[None, :]
    return np.linalg.inv(v)


def _fit_cells(spec: FunctionSpec, p0: float, p1: float, n_cells: int,
               degree: int):
    """Per-cell monomial coefficients (n_cells, degree+1) over [p0, p1]."""
    vinv = _vandermonde_inv(degree)
    h = (p1 - p0) / n_cells
    grid = (np.arange(n_cells, dtype=np.float64)[:, None]
            + np.arange(degree + 1, dtype=np.float64)[None, :] / degree)
    ys = np.asarray(spec.f(p0 + h * grid), dtype=np.float64)
    return ys @ vinv.T, h


def _cells_max_error(spec: FunctionSpec, p0: float, p1: float,
                     coeffs: np.ndarray, h: float, n_pts: int) -> float:
    """Dense-grid max |poly(x) - f(x)| over [p0, p1] (Horner, f64)."""
    xs = np.linspace(p0, p1, n_pts)
    u = (xs - p0) / h
    i = np.clip(np.floor(u).astype(np.int64), 0, coeffs.shape[0] - 1)
    t = np.clip(u - i, 0.0, 1.0)
    c = coeffs[i]
    y = c[:, -1]
    for lane in range(coeffs.shape[1] - 2, -1, -1):
        y = y * t + c[:, lane]
    return float(np.max(np.abs(y - np.asarray(spec.f(xs)))))


def _lane_residual(cells: np.ndarray) -> np.ndarray:
    """Per-lane chord residual across a run of cells ((K, d+1) -> same shape).

    The affine ramp through the first/last cell's coefficients is subtracted;
    runs of <= 2 cells are exactly representable (zero residual)."""
    k = cells.shape[0]
    if k <= 2:
        return np.zeros_like(cells)
    i = np.arange(k, dtype=np.float64)[:, None]
    ramp = cells[0] + (cells[-1] - cells[0]) * i / (k - 1)
    return cells - ramp


@dataclass(frozen=True)
class PolyMember:
    """One function's degree-d coefficient table (the PolyPack member artifact).

    Storage is cell-major with stride ``lanes = degree + 1``: the code of cell
    ``i``, lane ``l`` of sub-interval ``j`` lives at ``base[j] + i*lanes + l``.
    The runtime read path (all f32) dequantizes each lane with the QuantPack
    FMA and evaluates by Horner on the cell parameter ``t``:

        c_l = (zero[j,l] + ramp[j,l] * i) + scale[j,l] * q
        y   = (...(c_d * t + c_{d-1}) * t + ...) * t + c_0

    f32 members store raw coefficients with zero = ramp = 0, scale = 1 — the
    dequant FMA is then bit-exact identity, so one op sequence serves every
    width.
    """

    name: str
    degree: int
    bits: int  # 8 | 16 | 32 (32 = raw f32 coefficients)
    rho: float  # interpolation share of e_a (1.0 effective for bits=32)
    e_a: float
    lo: float
    hi: float
    algorithm: str
    boundaries: np.ndarray  # (n+1,) f64 sub-interval delimiters
    inv_delta: np.ndarray  # (n,) f64 reciprocal cell widths
    delta: np.ndarray  # (n,) f64 cell widths
    base: np.ndarray  # (n,) i64 first code index of sub-interval j
    seg_count: np.ndarray  # (n,) i64 cells per sub-interval
    zero: np.ndarray  # (n, lanes) f64
    ramp: np.ndarray  # (n, lanes) f64
    scale: np.ndarray  # (n, lanes) f64
    codes: np.ndarray  # (entries,) i64 codes, or f64 coefficients at bits=32

    @property
    def n_intervals(self) -> int:
        return len(self.boundaries) - 1

    @property
    def lanes(self) -> int:
        return self.degree + 1

    @property
    def entries(self) -> int:
        """Stored codes — the planner's footprint axis (M_F analogue)."""
        return int(len(self.codes))

    # a member's size under the name the table artifacts use
    footprint = entries

    @property
    def codes_bytes(self) -> int:
        return self.entries * (self.bits // 8)

    @property
    def meta_bytes(self) -> int:
        """f32 selector + dequant metadata: boundaries (n+1) plus inv_delta/
        base/seg_count (n each) plus zero/ramp/scale ((degree+1)*n each)."""
        n = self.n_intervals
        return ((3 + 3 * self.lanes) * n + (n + 1)) * 4

    def dequantize(self) -> np.ndarray:
        """Reconstructed f64 coefficients, flat cell-major like ``codes``."""
        out = np.empty(self.entries)
        lanes = self.lanes
        for j in range(self.n_intervals):
            s0 = int(self.base[j])
            k = int(self.seg_count[j])
            q = self.codes[s0:s0 + k * lanes].reshape(k, lanes)
            i = np.arange(k, dtype=np.float64)[:, None]
            out[s0:s0 + k * lanes] = (
                self.zero[j] + self.ramp[j] * i + self.scale[j] * q).ravel()
        return out

    def eval(self, x: np.ndarray) -> np.ndarray:
        """f64 dequantize-on-read Horner oracle (selector + lane FMAs)."""
        x = np.asarray(x, dtype=np.float64)
        j = np.clip(np.searchsorted(self.boundaries, x, side="right") - 1,
                    0, self.n_intervals - 1)
        u = (x - self.boundaries[j]) * self.inv_delta[j]
        i = np.clip(np.floor(u).astype(np.int64), 0, self.seg_count[j] - 1)
        t = np.clip(u - i, 0.0, 1.0)
        a = self.base[j] + i * self.lanes
        cs = [self.zero[j, lane] + self.ramp[j, lane] * i
              + self.scale[j, lane] * self.codes[a + lane]
              for lane in range(self.lanes)]
        y = cs[-1]
        for lane in range(self.lanes - 2, -1, -1):
            y = y * t + cs[lane]
        return y

    def max_error_on_grid(self, fn: Optional[FunctionSpec] = None,
                          n: int = 100_001) -> float:
        fn = fn or get_function(self.name)
        xs = np.linspace(self.lo, self.hi, n)
        xs = xs[xs < self.hi]
        return float(np.max(np.abs(self.eval(xs) - np.asarray(fn.f(xs)))))


def build_poly_member(
    fn: FunctionSpec | str,
    e_a: float,
    lo: Optional[float] = None,
    hi: Optional[float] = None,
    *,
    degree: int = 1,
    bits: int = 32,
    algorithm: str = "hierarchical",
    omega: float = 0.3,
    rho: float = DEFAULT_RHO,
    cap: int = DEFAULT_REFINE_CAP,
) -> PolyMember:
    """Design one degree-``degree`` member at storage width ``bits``.

    f32 members spend the whole ``e_a`` on interpolation; integer members
    split it ``rho / (1 - rho)`` between interpolation and per-lane rounding
    (the QuantPack budget convention).  Raises ``ValueError`` when no feasible
    encoding exists within the ``cap``-sub-interval refinement limit — the
    planner treats that as "candidate not in the menu".
    """
    spec = get_function(fn) if isinstance(fn, str) else fn
    if degree not in POLY_DEGREES:
        raise ValueError(f"degree must be one of {POLY_DEGREES}")
    if bits not in (8, 16, 32):
        raise ValueError("bits must be 8, 16 or 32")
    if not (0.0 < rho < 1.0):
        raise ValueError("rho must be in (0, 1)")
    lo = spec.interval[0] if lo is None else float(lo)
    hi = spec.interval[1] if hi is None else float(hi)
    e_interp = e_a if bits == 32 else rho * e_a
    lanes = degree + 1

    probe = deriv_probe(spec.name, lo, hi, degree + 1)
    if algorithm == "reference":
        partition = np.asarray([lo, hi], dtype=np.float64)
    else:
        adapter = _RemainderOracle(probe, e_interp, degree)
        partition = split(algorithm, spec, e_interp, lo, hi, omega,
                          oracle=adapter).partition

    # Per sub-interval: size cells from the remainder bound, then VERIFY the
    # fit on a dense f64 grid and refine — the artifact guarantee must not
    # depend on the finite-difference derivative estimate.
    target = e_interp * 0.999
    subs = []  # (p0, h, coeffs (K, lanes))
    for p0, p1 in zip(partition[:-1], partition[1:]):
        p0, p1 = float(p0), float(p1)
        h0 = poly_cell_width(probe.query(p0, p1), e_interp, degree)
        k = max(1, int(math.ceil((p1 - p0) / min(h0, p1 - p0) - 1e-12)))
        for _ in range(64):
            coeffs, h = _fit_cells(spec, p0, p1, k, degree)
            n_pts = max(513, 32 * k + 1)
            if _cells_max_error(spec, p0, p1, coeffs, h, n_pts) <= target:
                break
            k = max(k + 1, int(math.ceil(k * 1.25)))
        else:  # pragma: no cover - 64 rounds shrink h by > 1e6
            raise ValueError(
                f"{spec.name!r}: degree-{degree} fit did not converge on "
                f"[{p0}, {p1})")
        subs.append((p0, h, coeffs))

    # Integer widths: bisect sub-intervals at cell boundaries until every
    # lane's chord residual fits the per-lane rounding budget.  Cuts leave the
    # polynomial pieces (hence the codes) untouched; only metadata grows.
    if bits < 32:
        limit = quant_rounding_limit((1.0 - rho) * e_a / lanes, bits)

        def worst(si, a, b):
            r = _lane_residual(subs[si][2][a:b])
            return float(np.max(r.max(axis=0) - r.min(axis=0)))

        heap = []
        for si, (_, _, coeffs) in enumerate(subs):
            heapq.heappush(heap, (-worst(si, 0, coeffs.shape[0]),
                                  si, 0, coeffs.shape[0]))
        while len(heap) < cap:
            neg, si, a, b = heap[0]
            if -neg <= limit or b - a < 2:
                break
            heapq.heappop(heap)
            m = (a + b) // 2
            for a2, b2 in ((a, m), (m, b)):
                heapq.heappush(heap, (-worst(si, a2, b2), si, a2, b2))
        if -heap[0][0] > limit * (1 + 1e-12):
            raise ValueError(
                f"no feasible int{bits} coding for {spec.name!r} at "
                f"degree {degree}, e_a={e_a:g}, rho={rho} within the "
                f"{cap}-sub-interval refinement cap")
        pieces = sorted((si, a, b) for _, si, a, b in heap)
    else:
        limit = None
        pieces = [(si, 0, s[2].shape[0]) for si, s in enumerate(subs)]

    boundaries, deltas, bases, segs = [], [], [], []
    zero, ramp, scale, codes = [], [], [], []
    levels = (2 ** bits - 1) if bits < 32 else 0
    offset = 2 ** (bits - 1) if bits < 32 else 0
    acc = 0
    for si, a, b in pieces:
        p0, h, coeffs = subs[si]
        cells = coeffs[a:b]
        k = b - a
        boundaries.append(p0 + a * h if a else p0)
        deltas.append(h)
        bases.append(acc)
        segs.append(k)
        acc += k * lanes
        if bits == 32:
            zero.append(np.zeros(lanes))
            ramp.append(np.zeros(lanes))
            scale.append(np.ones(lanes))
            codes.append(cells.ravel())
            continue
        resid = _lane_residual(cells)
        rmin = resid.min(axis=0)
        rng = resid.max(axis=0) - rmin
        g = (cells[-1] - cells[0]) / (k - 1) if k > 1 else np.zeros(lanes)
        s = np.where(rng > 0.0, rng / levels, 0.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            q = np.where(s > 0.0,
                         np.clip(np.rint((resid - rmin) / np.where(s > 0, s, 1.0)),
                                 0, levels) - offset,
                         0.0)
        zero.append(np.where(rng > 0.0, cells[0] + rmin + s * offset, cells[0]))
        ramp.append(g)
        scale.append(s)
        codes.append(q.ravel())
    boundaries.append(float(partition[-1]))

    deltas = np.asarray(deltas, dtype=np.float64)
    return PolyMember(
        name=spec.name,
        degree=degree,
        bits=bits,
        rho=1.0 if bits == 32 else rho,
        e_a=float(e_a),
        lo=lo,
        hi=hi,
        algorithm=algorithm,
        boundaries=np.asarray(boundaries, dtype=np.float64),
        inv_delta=1.0 / deltas,
        delta=deltas,
        base=np.asarray(bases, dtype=np.int64),
        seg_count=np.asarray(segs, dtype=np.int64),
        zero=np.asarray(zero),
        ramp=np.asarray(ramp),
        scale=np.asarray(scale),
        codes=(np.concatenate(codes) if bits == 32
               else np.concatenate(codes).astype(np.int64)),
    )


def poly_member(
    name: str,
    e_a: float,
    lo: Optional[float] = None,
    hi: Optional[float] = None,
    *,
    degree: int = 1,
    bits: int = 32,
    algorithm: str = "hierarchical",
    omega: float = 0.3,
    rho: float = DEFAULT_RHO,
    cap: int = DEFAULT_REFINE_CAP,
) -> PolyMember:
    """Memoized registry-name member build (the ``cached_table`` idiom)."""
    return _member_cached(name, e_a, lo, hi, degree, bits, algorithm, omega,
                          rho, cap)


@lru_cache(maxsize=256)
@obs.traced("design.poly_member", "design")
def _member_cached(name, e_a, lo, hi, degree, bits, algorithm, omega, rho,
                   cap):
    return build_poly_member(name, e_a, lo, hi, degree=degree, bits=bits,
                             algorithm=algorithm, omega=omega, rho=rho,
                             cap=cap)


# --------------------------------------------------------------------------------------
# Candidate enumeration, Pareto filtering, budgeted selection.
# --------------------------------------------------------------------------------------


@dataclass(frozen=True)
class DesignCandidate:
    """One point of a function's design space: a built member plus its costs."""

    name: str
    degree: int
    dtype: str  # 'f32' | 'int16' | 'int8'
    entries: int
    codes_bytes: int
    meta_bytes: int
    member: PolyMember

    @property
    def bits(self) -> int:
        return DTYPE_BITS[self.dtype]

    @property
    def total_bytes(self) -> int:
        """Codes + metadata bytes (pre sublane padding) — the budget axis."""
        return self.codes_bytes + self.meta_bytes


def enumerate_candidates(
    name: str,
    e_a: float,
    *,
    degrees: Sequence[int] = POLY_DEGREES,
    dtypes: Sequence[str] = POLY_DTYPES,
    algorithm: str = "hierarchical",
    omega: float = 0.3,
    rho: float = DEFAULT_RHO,
    cap: int = DEFAULT_REFINE_CAP,
    lo: Optional[float] = None,
    hi: Optional[float] = None,
) -> list[DesignCandidate]:
    """The feasible (degree, dtype) menu for one function, every point built
    and verified.  Infeasible integer codings are silently dropped."""
    out = []
    for degree in degrees:
        for dtype in dtypes:
            if dtype not in DTYPE_BITS:
                raise ValueError(
                    f"dtype must be one of {sorted(DTYPE_BITS)}, got {dtype!r}")
            try:
                m = poly_member(name, e_a, lo, hi, degree=degree,
                                bits=DTYPE_BITS[dtype], algorithm=algorithm,
                                omega=omega, rho=rho, cap=cap)
            except ValueError:
                continue
            out.append(DesignCandidate(
                name=name, degree=degree, dtype=dtype, entries=m.entries,
                codes_bytes=m.codes_bytes, meta_bytes=m.meta_bytes, member=m))
    if not out:
        raise ValueError(
            f"no feasible design candidate for {name!r} at e_a={e_a:g} over "
            f"degrees={tuple(degrees)}, dtypes={tuple(dtypes)}")
    return out


def pareto_front(candidates: Sequence[DesignCandidate]) -> list[DesignCandidate]:
    """The (entries, total_bytes) non-dominated subset, entries-ascending."""
    front = []
    for c in candidates:
        if any(o.entries <= c.entries and o.total_bytes <= c.total_bytes
               and (o.entries < c.entries or o.total_bytes < c.total_bytes)
               for o in candidates):
            continue
        front.append(c)
    return sorted(front, key=lambda c: (c.entries, c.total_bytes))


def _auto_key(c: DesignCandidate):
    """Cheapest-first: bytes, then entries, then lower degree / wider dtype."""
    return (c.total_bytes, c.entries, c.degree, -c.bits)


def _preferred_key(c: DesignCandidate):
    """Quality-first: lowest degree (fewest runtime FMAs), widest dtype
    (least rounding), then fewer bytes."""
    return (c.degree, -c.bits, c.total_bytes)


@dataclass(frozen=True)
class PackPlan:
    """A per-function candidate selection plus its pack-level accounting."""

    names: Tuple[str, ...]
    chosen: Tuple[DesignCandidate, ...]
    e_a: float
    budget_bytes: Optional[int]

    @property
    def members(self) -> Tuple[PolyMember, ...]:
        return tuple(c.member for c in self.chosen)

    @property
    def total_entries(self) -> int:
        return sum(c.entries for c in self.chosen)

    @property
    def total_bytes(self) -> int:
        return sum(c.total_bytes for c in self.chosen)

    def smem(self, budget_bytes: int = SMEM_BYTES) -> SmemPackCost:
        """Shared-memory residency of the planned pack's staging image: the
        image ``approx.table_pack.build_poly_pack`` builds from this plan
        (``PolyPackLayout.smem``), its dequant lanes padded to the widest
        member's, as the device pack stores them."""
        return poly_pack_layout(list(self.members)).smem(budget_bytes)

    def describe(self) -> str:
        rows = [f"  {c.name:<12} d={c.degree} {c.dtype:<5} "
                f"entries={c.entries:<5} bytes={c.total_bytes}"
                for c in self.chosen]
        head = (f"PackPlan e_a={self.e_a:g} budget="
                f"{self.budget_bytes if self.budget_bytes else 'none'} "
                f"entries={self.total_entries} bytes={self.total_bytes}")
        return "\n".join([head] + rows)


@obs.traced("design.plan", "design")
def plan(
    names: Sequence[str],
    e_a: float,
    budget_bytes: Optional[int] = None,
    *,
    degrees: Sequence[int] = POLY_DEGREES,
    dtypes: Sequence[str] = POLY_DTYPES,
    algorithm: str = "hierarchical",
    omega: float = 0.3,
    rho: float = DEFAULT_RHO,
    cap: int = DEFAULT_REFINE_CAP,
    intervals: Optional[dict] = None,
) -> PackPlan:
    """Pick one design candidate per function.

    ``budget_bytes=None``: every function takes its cheapest candidate
    (bytes, then entries) — the minimal-footprint pack.  With a budget, every
    function starts at its *preferred* candidate (lowest degree, widest
    dtype — fewest runtime FMAs, least rounding) and the planner greedily
    switches the function with the largest byte saving to its cheapest
    candidate until total codes+metadata bytes fit; infeasible budgets raise
    ``ValueError``.  Every returned member independently meets the e_a bound —
    the budget trades bytes against runtime cost, never against accuracy.
    """
    names = tuple(names)
    if not names:
        raise ValueError("plan needs at least one function name")
    intervals = intervals or {}
    menus = {}
    for n in names:
        lo, hi = intervals.get(n, (None, None))
        menus[n] = enumerate_candidates(
            n, e_a, degrees=degrees, dtypes=dtypes, algorithm=algorithm,
            omega=omega, rho=rho, cap=cap, lo=lo, hi=hi)
    if budget_bytes is None:
        chosen = {n: min(menus[n], key=_auto_key) for n in names}
    else:
        if budget_bytes <= 0:
            raise ValueError("budget_bytes must be positive")
        chosen = {n: min(menus[n], key=_preferred_key) for n in names}

        def total():
            return sum(c.total_bytes for c in chosen.values())

        while total() > budget_bytes:
            best_name, best_alt, best_save = None, None, 0
            for n in names:
                alt = min(menus[n], key=_auto_key)
                save = chosen[n].total_bytes - alt.total_bytes
                if save > best_save:
                    best_name, best_alt, best_save = n, alt, save
            if best_name is None:
                raise ValueError(
                    f"pack budget {budget_bytes} B infeasible: the cheapest "
                    f"plan for {names} at e_a={e_a:g} needs {total()} B")
            chosen[best_name] = best_alt
    return PackPlan(names=names, chosen=tuple(chosen[n] for n in names),
                    e_a=float(e_a), budget_bytes=budget_bytes)
