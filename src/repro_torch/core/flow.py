"""The design flow's memoized entry point (paper Sec. 6): function + E_a +
algorithm -> :class:`TableSpec`.

The port's copy of ``repro.core.flow.cached_table``.  Artifacts are cached per
(function, interval, E_a, algorithm, omega) because model constructors request
the same handful of tables many times.  The BRAM/VMEM cost report
(``run_flow``) is not on the serving path and is not carried over.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

from repro_torch import obs

from .table import TableSpec, build_table


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
