"""TableSpec — the compiled artifact of the design flow (the paper's 'VHDL output').

A :class:`TableSpec` packs everything the lookup hardware (Fig. 7) needs:

  * ``boundaries``  (n+1,)  sub-interval delimiters  P            — interval selector
  * ``inv_delta``   (n,)    1/delta_j reciprocals                 — address generator
  * ``base``        (n,)    BRAM base address A_j of sub-table j  — address generator
  * ``seg_count``   (n,)    kappa_j - 1 segments per sub-interval — address clamp
  * ``values``      (M_F,)  packed range values Y                 — the BRAM content

Evaluation (both the numpy oracle here and the torch/CUDA runtimes) mirrors the
circuit: select sub-interval j, compute i = floor((x - p_j) * inv_delta_j) clamped to
[0, seg_count_j - 1], fetch y at base_j + i and base_j + i + 1, lerp.

Inputs outside [p_0, p_n) saturate to the boundary sub-intervals — the hardware
analogue of address clamping — so the spec is total on the reals.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .functions import FunctionSpec, get as get_function
from .spacing import SecondDerivMax, reference_spacing
from .splitting import SplitResult, split


@dataclass(frozen=True)
class TableSpec:
    name: str
    lo: float
    hi: float
    e_a: float
    algorithm: str
    boundaries: np.ndarray  # (n+1,) f64
    inv_delta: np.ndarray  # (n,)   f64
    delta: np.ndarray  # (n,)   f64
    base: np.ndarray  # (n,)   i64  — first table index of sub-interval j
    seg_count: np.ndarray  # (n,)   i64  — segments per sub-interval (= kappa_j - 1)
    values: np.ndarray  # (M_F,) f64  — packed breakpoint range values

    @property
    def n_intervals(self) -> int:
        return len(self.boundaries) - 1

    @property
    def footprint(self) -> int:
        """Stored entries, Eq. (13) accounting: sum of per-sub-interval kappa_j."""
        return int(len(self.values))

    # ---------------------------- numpy oracle ----------------------------------

    def eval(self, x: np.ndarray) -> np.ndarray:
        """Piecewise-linear table evaluation; the ground-truth oracle for all runtimes."""
        x = np.asarray(x, dtype=np.float64)
        # interval select: j = (#boundaries <= x) - 1, clamped — the comparator plane
        j = np.searchsorted(self.boundaries, x, side="right") - 1
        j = np.clip(j, 0, self.n_intervals - 1)
        p_j = self.boundaries[j]
        i = np.floor((x - p_j) * self.inv_delta[j]).astype(np.int64)
        i = np.clip(i, 0, self.seg_count[j] - 1)
        a = self.base[j] + i
        y0 = self.values[a]
        y1 = self.values[a + 1]
        x_i = p_j + i * self.delta[j]
        t = (x - x_i) * self.inv_delta[j]
        t = np.clip(t, 0.0, 1.0)  # saturate out-of-range inputs
        return y0 + t * (y1 - y0)

    def max_error_on_grid(self, fn: Optional[FunctionSpec] = None, n: int = 200_001):
        """max |table(x) - f(x)| over a dense probe grid — must be <= e_a (+fp slack)."""
        fn = fn or get_function(self.name)
        xs = np.linspace(self.lo, self.hi, n)
        xs = xs[xs < self.hi]
        return float(np.max(np.abs(self.eval(xs) - np.asarray(fn.f(xs)))))


def build_table(
    fn: FunctionSpec | str,
    e_a: float,
    lo: Optional[float] = None,
    hi: Optional[float] = None,
    algorithm: str = "hierarchical",
    omega: float = 0.3,
    *,
    split_result: Optional[SplitResult] = None,
    **split_kw,
) -> TableSpec:
    """Run the design flow: split the interval, then materialize the packed table."""
    fn = get_function(fn) if isinstance(fn, str) else fn
    lo = fn.interval[0] if lo is None else lo
    hi = fn.interval[1] if hi is None else hi

    if algorithm == "reference":
        oracle = SecondDerivMax(fn, lo, hi)
        ref = reference_spacing(oracle, e_a, lo, hi)
        partition = np.asarray([lo, hi], dtype=np.float64)
        deltas = np.asarray([ref.delta])
        counts = np.asarray([ref.footprint], dtype=np.int64)
    else:
        sr = split_result or split(algorithm, fn, e_a, lo, hi, omega, **split_kw)
        partition, deltas, counts = sr.partition, sr.spacings, sr.counts

    bases, values, deltas_eff = [], [], []
    acc = 0
    for (p0, p1), d, k in zip(zip(partition[:-1], partition[1:]), deltas, counts):
        bases.append(acc)
        # kappa_j = n_seg + 1 entries (Eq. 12).  We place them to span [p0, p1]
        # EXACTLY with d_eff = len/n_seg <= delta: same footprint as the paper's
        # ceil-overshoot layout, but the last segment never extends past p1 where
        # |f''| may exceed the sub-interval max (which would break the Eq. 10
        # guarantee — caught by tests/test_properties.py on tanh).
        n_seg = int(k) - 1
        d_eff = (p1 - p0) / n_seg
        deltas_eff.append(d_eff)
        xs = p0 + d_eff * np.arange(k, dtype=np.float64)
        xs[-1] = p1  # exact, no float drift
        values.append(np.asarray(fn.f(xs), dtype=np.float64))
        acc += int(k)
    deltas = np.asarray(deltas_eff, dtype=np.float64)
    return TableSpec(
        name=fn.name,
        lo=float(lo),
        hi=float(hi),
        e_a=float(e_a),
        algorithm=algorithm,
        boundaries=np.asarray(partition, dtype=np.float64),
        inv_delta=1.0 / np.asarray(deltas, dtype=np.float64),
        delta=np.asarray(deltas, dtype=np.float64),
        base=np.asarray(bases, dtype=np.int64),
        seg_count=np.maximum(np.asarray(counts, dtype=np.int64) - 1, 1),
        values=np.concatenate(values),
    )
