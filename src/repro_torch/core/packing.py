"""Multi-function pack layout — all of a model's tables as ONE artifact.

The port's copy of ``repro.core.packing.PackLayout`` / ``pack_layout`` (the f32
pack only; the quantized, polynomial and sharded layouts come with their
slices).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from .table import TableSpec


@dataclass(frozen=True)
class PackLayout:
    """Layout of F tables packed into one values vector + padded metadata planes.

    This is the paper's BRAM-instantiation idea applied across the WHOLE function
    set: instead of one BRAM (on-chip residency + kernel dispatch) per function,
    all range values live in a single concatenated ``values`` vector and the
    selector metadata is stored as (F, n_max)-padded planes so one kernel,
    indexing a metadata row by ``fn_id``, serves any member function.

      * ``boundaries``  (F, n_max+1)  right-padded with +inf — padding never wins
        a ``x >= b`` compare, so the vectorized selector needs no per-function
        comparator count;
      * ``inv_delta`` / ``delta`` (F, n_max)  padded with 1.0 (never selected);
      * ``base``        (F, n_max)  GLOBAL indices into ``values`` (the
        per-function BRAM base address A_j plus the function's pack offset);
      * ``seg_count``   (F, n_max)  padded with 1;
      * ``values``      (sum_f M_f,)  every function's packed range values.
    """

    names: Tuple[str, ...]
    specs: Tuple[TableSpec, ...]
    n_intervals: Tuple[int, ...]  # real (unpadded) sub-interval count per function
    n_max: int
    boundaries: np.ndarray  # (F, n_max+1) f64
    inv_delta: np.ndarray  # (F, n_max)   f64
    delta: np.ndarray  # (F, n_max)   f64
    base: np.ndarray  # (F, n_max)   i64 — global index into the packed values
    seg_count: np.ndarray  # (F, n_max)   i64
    value_offset: np.ndarray  # (F,)     i64 — first values index of function f
    values: np.ndarray  # (sum M_f,)   f64

    @property
    def n_functions(self) -> int:
        return len(self.names)

    @property
    def footprint(self) -> int:
        """Total stored entries across the pack (sum of member Eq. 13 footprints)."""
        return int(len(self.values))

    def fn_id(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(
                f"function {name!r} not in pack {self.names}") from None


def pack_layout(specs: Sequence[TableSpec]) -> PackLayout:
    """Concatenate per-function TableSpecs into one PackLayout.

    Member metadata is copied verbatim (same f64 values as the per-table
    artifacts), so a runtime evaluating through the pack reproduces per-table
    evaluation bit for bit; only ``base`` is rebased by the pack offset.
    """
    if not specs:
        raise ValueError("cannot pack zero tables")
    names = tuple(s.name for s in specs)
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate function names in pack: {names}")
    n_list = tuple(s.n_intervals for s in specs)
    n_max = max(n_list)
    F = len(specs)
    boundaries = np.full((F, n_max + 1), np.inf, dtype=np.float64)
    inv_delta = np.ones((F, n_max), dtype=np.float64)
    delta = np.ones((F, n_max), dtype=np.float64)
    base = np.zeros((F, n_max), dtype=np.int64)
    seg_count = np.ones((F, n_max), dtype=np.int64)
    value_offset = np.zeros((F,), dtype=np.int64)
    acc = 0
    for f, s in enumerate(specs):
        n = s.n_intervals
        boundaries[f, : n + 1] = s.boundaries
        inv_delta[f, :n] = s.inv_delta
        delta[f, :n] = s.delta
        base[f, :n] = s.base + acc
        seg_count[f, :n] = s.seg_count
        value_offset[f] = acc
        acc += s.footprint
    return PackLayout(
        names=names,
        specs=tuple(specs),
        n_intervals=n_list,
        n_max=n_max,
        boundaries=boundaries,
        inv_delta=inv_delta,
        delta=delta,
        base=base,
        seg_count=seg_count,
        value_offset=value_offset,
        values=np.concatenate([s.values for s in specs]),
    )
