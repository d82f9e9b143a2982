"""The paper's three interval-splitting algorithms (Algorithms 1-3).

All three return a partition ``P = [p_0 < p_1 < ... < p_n]`` of the input interval
``[x0, x0 + a)`` such that per-sub-interval uniform spacings (Eq. 11) never violate
the maximum approximation error ``E_a`` anywhere.

Acceptance criterion — paper erratum
------------------------------------
The pseudocode in the paper writes the split-acceptance test as

    kappa_1 + kappa_2 < kappa_parent * omega            (Alg. 1 line 13 etc.)

but its prose ("omega = 0.3 indicates that an interval split must lead to a footprint
reduction of AT LEAST 30%") and *all three* worked examples (Sec. 5.1: 415 < 770
accepted at omega=0.3; Sec. 5.2: 258 accepted; Sec. 5.3: 526 accepted with a stated
31.6% reduction vs the 30% threshold) are only consistent with

    kappa_1 + kappa_2 < kappa_parent * (1 - omega)      (reduction > omega)

We implement the example-consistent form.  ``tests/test_splitting.py`` reproduces the
paper's worked examples against it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from .functions import FunctionSpec, get as get_function
from .spacing import SecondDerivMax, delta_for, footprint


@dataclass(frozen=True)
class SplitResult:
    """Partition plus the per-sub-interval spacing/footprint sets (P, S, K)."""

    partition: np.ndarray  # (n+1,) float64, p_0 = x0, p_n = x0 + a
    spacings: np.ndarray  # (n,) float64 delta_j
    counts: np.ndarray  # (n,) int64 kappa_j = M_F(delta_j, [p_j, p_{j+1}))
    algorithm: str
    omega: float
    e_a: float

    @property
    def n_intervals(self) -> int:
        return len(self.partition) - 1

    @property
    def footprint(self) -> int:
        """M_F^P = sum_j kappa_j (Eq. 13)."""
        return int(self.counts.sum())


def _finalize(
    fn: FunctionSpec,
    oracle: SecondDerivMax,
    boundaries: List[float],
    e_a: float,
    omega: float,
    algorithm: str,
) -> SplitResult:
    p = np.asarray(sorted(set(boundaries)), dtype=np.float64)
    deltas, counts = [], []
    for lo, hi in zip(p[:-1], p[1:]):
        d = delta_for(oracle, e_a, float(lo), float(hi))
        deltas.append(d)
        counts.append(footprint(d, float(lo), float(hi)))
    return SplitResult(
        partition=p,
        spacings=np.asarray(deltas, dtype=np.float64),
        counts=np.asarray(counts, dtype=np.int64),
        algorithm=algorithm,
        omega=omega,
        e_a=e_a,
    )


def _accept(kappa_split: int, kappa_parent: int, omega: float) -> bool:
    """Example-consistent acceptance: footprint reduction strictly exceeds omega."""
    return kappa_split < kappa_parent * (1.0 - omega)


# --------------------------------------------------------------------------------------
# Algorithm 1 — Binary segmentation (recursive midpoint).
# --------------------------------------------------------------------------------------


def binary_split(
    fn: FunctionSpec | str,
    e_a: float,
    lo: float,
    hi: float,
    omega: float = 0.3,
    *,
    min_width: float = 1e-9,
    max_depth: int = 40,
    oracle: SecondDerivMax | None = None,
) -> SplitResult:
    """Algorithm 1: recursively split at the midpoint while the footprint reduction
    exceeds ``omega``."""
    fn = get_function(fn) if isinstance(fn, str) else fn
    if not (0.0 < omega <= 1.0):
        raise ValueError("omega must be in (0, 1]")
    oracle = oracle or SecondDerivMax(fn, lo, hi)

    out: List[float] = []

    def rec(a: float, b: float, depth: int) -> None:
        out.append(a)
        if depth >= max_depth or (b - a) <= 2.0 * min_width:
            out.append(b)
            return
        dp = delta_for(oracle, e_a, a, b)
        kp = footprint(dp, a, b)
        bp = 0.5 * (a + b)
        d1 = delta_for(oracle, e_a, a, bp)
        d2 = delta_for(oracle, e_a, bp, b)
        if d1 != d2:  # paper line 8: identical spacings => no point splitting
            k1 = footprint(d1, a, bp)
            k2 = footprint(d2, bp, b)
            if _accept(k1 + k2, kp, omega):
                rec(a, bp, depth + 1)
                rec(bp, b, depth + 1)
                return
        out.append(b)

    rec(float(lo), float(hi), 0)
    return _finalize(fn, oracle, out, e_a, omega, "binary")


# --------------------------------------------------------------------------------------
# Algorithm 2 — Hierarchical segmentation (recursive best-sweep-point).
# --------------------------------------------------------------------------------------


def hierarchical_split(
    fn: FunctionSpec | str,
    e_a: float,
    lo: float,
    hi: float,
    omega: float = 0.3,
    epsilon: float | None = None,
    *,
    max_depth: int = 40,
    oracle: SecondDerivMax | None = None,
) -> SplitResult:
    """Algorithm 2: sweep candidates ``p_i + j*epsilon``, split at the footprint-
    minimizing candidate when the reduction exceeds ``omega``; recurse."""
    fn = get_function(fn) if isinstance(fn, str) else fn
    if not (0.0 < omega <= 1.0):
        raise ValueError("omega must be in (0, 1]")
    if epsilon is None:
        epsilon = (hi - lo) / 1000.0  # paper's example density
    if epsilon <= 0:
        raise ValueError("epsilon must be positive")
    oracle = oracle or SecondDerivMax(fn, lo, hi)

    out: List[float] = []

    def rec(a: float, b: float, depth: int) -> None:
        out.append(a)
        j_max = int(np.floor((b - a) / epsilon + 1e-12))
        if depth >= max_depth or j_max < 2:
            out.append(b)
            return
        dp = delta_for(oracle, e_a, a, b)
        kp = footprint(dp, a, b)
        # Vectorized sweep over interior candidates j in [1, j_max - 1].
        best_cost, best_sp = None, None
        for j in range(1, j_max):
            sp = a + j * epsilon
            if sp <= a or sp >= b:
                continue
            c = footprint(delta_for(oracle, e_a, a, sp), a, sp) + footprint(
                delta_for(oracle, e_a, sp, b), sp, b
            )
            if best_cost is None or c < best_cost:
                best_cost, best_sp = c, sp
        if best_cost is not None and _accept(best_cost, kp, omega):
            rec(a, best_sp, depth + 1)
            rec(best_sp, b, depth + 1)
            return
        out.append(b)

    rec(float(lo), float(hi), 0)
    return _finalize(fn, oracle, out, e_a, omega, "hierarchical")


# --------------------------------------------------------------------------------------
# Algorithm 3 — Sequential segmentation (single left-to-right sweep).
# --------------------------------------------------------------------------------------


def sequential_split(
    fn: FunctionSpec | str,
    e_a: float,
    lo: float,
    hi: float,
    omega: float = 0.3,
    epsilon: float | None = None,
    *,
    oracle: SecondDerivMax | None = None,
) -> SplitResult:
    """Algorithm 3: sweep candidates ``x0 + i*epsilon`` once; greedily commit any
    split whose footprint reduction (vs the current tail interval) exceeds ``omega``."""
    fn = get_function(fn) if isinstance(fn, str) else fn
    if not (0.0 < omega <= 1.0):
        raise ValueError("omega must be in (0, 1]")
    if epsilon is None:
        epsilon = (hi - lo) / 50.0  # paper's example uses 0.3 on a 15-wide interval
    if epsilon <= 0:
        raise ValueError("epsilon must be positive")
    oracle = oracle or SecondDerivMax(fn, lo, hi)

    boundaries: List[float] = [float(lo)]
    x_p = float(lo)
    d_p = delta_for(oracle, e_a, x_p, hi)
    k_p = footprint(d_p, x_p, hi)
    i_max = int(np.floor((hi - lo) / epsilon + 1e-12))
    for i in range(1, i_max):
        sp = lo + i * epsilon
        if sp <= x_p or sp >= hi:
            continue
        k1 = footprint(delta_for(oracle, e_a, x_p, sp), x_p, sp)
        k2 = footprint(delta_for(oracle, e_a, sp, hi), sp, hi)
        if _accept(k1 + k2, k_p, omega):
            boundaries.append(float(sp))
            x_p = float(sp)
            d_p = delta_for(oracle, e_a, x_p, hi)
            k_p = footprint(d_p, x_p, hi)
    boundaries.append(float(hi))
    return _finalize(fn, oracle, boundaries, e_a, omega, "sequential")


ALGORITHMS = {
    "binary": binary_split,
    "hierarchical": hierarchical_split,
    "sequential": sequential_split,
}


def split(
    algorithm: str,
    fn: FunctionSpec | str,
    e_a: float,
    lo: float,
    hi: float,
    omega: float = 0.3,
    **kw,
) -> SplitResult:
    try:
        f = ALGORITHMS[algorithm]
    except KeyError:
        raise KeyError(f"unknown algorithm {algorithm!r}; known: {sorted(ALGORITHMS)}")
    return f(fn, e_a, lo, hi, omega, **kw)
