"""The automated design flow (paper Sec. 6): function + E_a + algorithm -> artifact.

The port's copy of ``repro.core.flow``.  :func:`run_flow` is the software
analogue of the paper's VHDL generation: it runs an interval-splitting
algorithm, materializes the packed :class:`TableSpec`, and reports the
resource costs under both packing models: BRAM18 for paper fidelity, and the
shared-memory staging image of the table kernels (``core.bram.smem_cost``)
where the reference reports TPU VMEM.  :func:`cached_table` memoizes the
artifact per (function, interval, E_a, algorithm, omega) because model
constructors request the same handful of tables many times.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

from repro_torch import obs

from . import bram
from .functions import FunctionSpec, get as get_function
from .spacing import SecondDerivMax, reference_spacing
from .table import TableSpec, build_table


@dataclass(frozen=True)
class FlowReport:
    spec: TableSpec
    reference_footprint: int
    footprint: int
    reduction_pct: float
    n_intervals: int
    brams: int
    brams_reference: int
    smem: bram.SmemCost
    measured_max_error: Optional[float] = None

    def summary(self) -> str:
        where = "staged" if self.smem.fits else "past the budget"
        return (
            f"{self.spec.name}[{self.spec.lo},{self.spec.hi}) Ea={self.spec.e_a:g} "
            f"{self.spec.algorithm}: M_F {self.reference_footprint} -> {self.footprint} "
            f"(-{self.reduction_pct:.1f}%), intervals={self.n_intervals}, "
            f"BRAM {self.brams_reference} -> {self.brams}, "
            f"SMEM {self.smem.image_bytes}B ({self.smem.fraction * 100:.3f}% of "
            f"the {self.smem.budget_bytes}B block budget, {where})"
        )


def run_flow(
    fn: FunctionSpec | str,
    e_a: float,
    lo: Optional[float] = None,
    hi: Optional[float] = None,
    algorithm: str = "hierarchical",
    omega: float = 0.3,
    *,
    verify_error: bool = False,
    **split_kw,
) -> FlowReport:
    fn = get_function(fn) if isinstance(fn, str) else fn
    lo = fn.interval[0] if lo is None else lo
    hi = fn.interval[1] if hi is None else hi
    spec = build_table(fn, e_a, lo, hi, algorithm, omega, **split_kw)
    oracle = SecondDerivMax(fn, lo, hi)
    ref = reference_spacing(oracle, e_a, lo, hi)
    red = 100.0 * (ref.footprint - spec.footprint) / ref.footprint
    return FlowReport(
        spec=spec,
        reference_footprint=ref.footprint,
        footprint=spec.footprint,
        reduction_pct=red,
        n_intervals=spec.n_intervals,
        brams=bram.bram_count(spec.footprint),
        brams_reference=bram.bram_count(ref.footprint),
        smem=bram.smem_cost(spec.footprint, spec.n_intervals),
        measured_max_error=(spec.max_error_on_grid(fn) if verify_error else None),
    )


@lru_cache(maxsize=256)
@obs.traced("design.splitter", "design")
def cached_table(
    name: str,
    e_a: float,
    lo: Optional[float] = None,
    hi: Optional[float] = None,
    algorithm: str = "hierarchical",
    omega: float = 0.3,
) -> TableSpec:
    """Memoized design-flow entry point used by model constructors."""
    return build_table(name, e_a, lo, hi, algorithm, omega)
