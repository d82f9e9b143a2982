"""Error-bounded uniform breakpoint spacing — the paper's *Reference* approach.

Implements Eq. (10)-(12):

    E_i      = delta_i^2 / 8 * max|f''|                        (Eq. 10)
    delta    = sqrt(8 * E_a / max_{[a,b)} |f''|)               (Eq. 11)
    M_F      = ceil((b - a) / delta) + 1                       (Eq. 12)

``max|f''|`` over arbitrary sub-intervals is needed *many* times by the splitting
algorithms (a hierarchical sweep evaluates it twice per candidate), so this module
provides :class:`SecondDerivMax` — a sparse-table range-max oracle built once per
(function, base-interval) over a dense grid, answering sub-interval max queries in
O(1).  Endpoint values are always folded in analytically so the result upper-bounds
the grid discretization for the monotone/convex segments the benchmark functions have.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .functions import FunctionSpec


class SecondDerivMax:
    """O(1) range-max queries of |f''| over sub-intervals of a base interval.

    A sparse table (binary-lifting range max) over ``grid_n`` samples of |f''|,
    plus analytic endpoint evaluation.  Build: O(n log n); query: O(1).
    """

    def __init__(self, spec: FunctionSpec, lo: float, hi: float, grid_n: int = 16385):
        if hi <= lo:
            raise ValueError(f"empty base interval [{lo}, {hi})")
        self.spec = spec
        self.lo = float(lo)
        self.hi = float(hi)
        self.grid_n = int(grid_n)
        self._xs = np.linspace(self.lo, self.hi, self.grid_n)
        vals = np.abs(np.asarray(spec.d2f(self._xs), dtype=np.float64))
        if not np.all(np.isfinite(vals)):
            raise ValueError(
                f"|f''| not finite on [{lo}, {hi}) for {spec.name!r}; "
                "the paper's bound (Eq. 10) requires a finite second derivative"
            )
        # sparse table: table[k] holds max over windows of length 2^k
        levels = max(1, int(math.floor(math.log2(self.grid_n))) + 1)
        self._table = [vals]
        for k in range(1, levels):
            prev = self._table[-1]
            half = 1 << (k - 1)
            if len(prev) <= half:
                break
            self._table.append(np.maximum(prev[:-half], prev[half:]))
        self._step = (self.hi - self.lo) / (self.grid_n - 1)

    def query(self, a: float, b: float) -> float:
        """max |f''| over [a, b] (inclusive), clipped to the base interval."""
        if b <= a:
            raise ValueError(f"empty interval [{a}, {b})")
        a = max(a, self.lo)
        b = min(b, self.hi)
        # widen to the surrounding grid points => conservative for any |f''| with
        # bounded variation between samples; endpoints folded in analytically below.
        i0 = max(0, int(math.floor((a - self.lo) / self._step)))
        i1 = min(self.grid_n - 1, int(math.ceil((b - self.lo) / self._step)))
        if i1 <= i0:
            i1 = min(self.grid_n - 1, i0 + 1)
        span = i1 - i0 + 1
        k = span.bit_length() - 1
        if k >= len(self._table):
            k = len(self._table) - 1
        w = 1 << k
        t = self._table[k]
        m = float(max(t[i0], t[i1 - w + 1]))
        # analytic endpoints (exact, independent of grid)
        d2 = self.spec.d2f
        m = max(m, abs(float(d2(np.asarray(a)))), abs(float(d2(np.asarray(b)))))
        return m


@dataclass(frozen=True)
class SpacingResult:
    delta: float
    max_abs_d2: float
    footprint: int


def delta_for(
    spec_or_maxd2, e_a: float, lo: float, hi: float
) -> float:
    """Largest admissible uniform spacing (Eq. 11), capped at the interval length.

    ``spec_or_maxd2`` is either a :class:`FunctionSpec` (direct grid max) or a
    :class:`SecondDerivMax` oracle (O(1) range queries).
    """
    if e_a <= 0:
        raise ValueError("E_a must be positive")
    if hi <= lo:
        raise ValueError(f"empty interval [{lo}, {hi})")
    if isinstance(spec_or_maxd2, SecondDerivMax):
        m = spec_or_maxd2.query(lo, hi)
    else:
        m = spec_or_maxd2.max_abs_d2(lo, hi)
    length = hi - lo
    if m <= 0.0:
        return length  # truly linear on [lo, hi): two breakpoints suffice
    return min(length, math.sqrt(8.0 * e_a / m))


def footprint(delta: float, lo: float, hi: float) -> int:
    """M_F = ceil((hi - lo)/delta) + 1 (Eq. 12), with a float-fuzz guard."""
    if delta <= 0:
        raise ValueError("delta must be positive")
    length = hi - lo
    n_seg = math.ceil(length / delta - 1e-12)
    return int(max(1, n_seg)) + 1


def reference_spacing(
    spec_or_maxd2, e_a: float, lo: float, hi: float
) -> SpacingResult:
    """The paper's *Reference* approach over [lo, hi): one uniform spacing."""
    d = delta_for(spec_or_maxd2, e_a, lo, hi)
    if isinstance(spec_or_maxd2, SecondDerivMax):
        m = spec_or_maxd2.query(lo, hi)
    else:
        m = spec_or_maxd2.max_abs_d2(lo, hi)
    return SpacingResult(delta=d, max_abs_d2=m, footprint=footprint(d, lo, hi))
