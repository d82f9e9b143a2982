"""Multi-function pack layout — all of a model's tables as ONE artifact.

The port's copy of ``repro.core.packing``: the f32 :class:`PackLayout`, the
QuantPack layout (int8/int16 codes + ragged dequant metadata), the PolyPack
layout (degree-d coefficient codes, lane-padded dequant metadata) and the
ShardedPack layout (the f32 values vector cut into per-shard slices).  The
reference's ``vmem()`` reports (TPU VMEM residency over ``core/bram.py``) are
not carried over (queue 1, item 15): the port's counterpart is the CUDA
kernels' shared-memory staging.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Sequence, Tuple

import numpy as np

from .quantize import QuantMember
from .table import TableSpec

if TYPE_CHECKING:  # for the annotations only: design imports this package
    from .design import PolyMember


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


# --------------------------------------------------------------------------------------
# ShardedPack layout — the pack's values vector cut into per-shard slices.
# --------------------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardedPackLayout:
    """A :class:`PackLayout` whose ``values`` vector is partitioned over
    ``n_shards`` shards at SUB-INTERVAL granularity.

    Each sub-interval ``(f, j)`` owns a contiguous ``seg_count + 1``-entry run
    of ``values`` (runs never share endpoint entries), so a shard that owns
    whole sub-intervals owns a contiguous slice, and every adjacent-pair
    gather ``(a, a+1)`` stays inside it.

      * ``owner``       (F, n_max)  which shard answers sub-interval (f, j);
        padding columns are owned by no shard (-1);
      * ``local_base``  (F, n_max)  the GLOBAL ``base`` rebased into the
        owner's slice, ``base - shard_offsets[owner]`` (0 where unowned);
      * ``shard_offsets`` (S,)      first global values index of each shard;
      * ``shard_sizes``   (S,)      real (unpadded) entries per shard.

    The selector metadata (boundaries / inv_delta / seg_count) stays
    replicated: every shard runs the whole comparator plane to learn whether
    it owns the selected sub-interval.  Only the values are partitioned.
    """

    layout: PackLayout
    n_shards: int
    owner: np.ndarray  # (F, n_max) i64, -1 on padding columns
    local_base: np.ndarray  # (F, n_max) i64 — rebased into the owner's slice
    shard_offsets: np.ndarray  # (S,) i64
    shard_sizes: np.ndarray  # (S,) i64

    @property
    def names(self) -> Tuple[str, ...]:
        return self.layout.names

    @property
    def n_intervals(self) -> Tuple[int, ...]:
        return self.layout.n_intervals

    @property
    def footprint(self) -> int:
        return self.layout.footprint

    @property
    def max_shard_entries(self) -> int:
        """Per-shard values high-water: every slice is padded to it, so the
        slices stack into one (S, m_max) operand."""
        return max(1, int(self.shard_sizes.max()))

    def shard_values(self, s: int) -> np.ndarray:
        """Shard ``s``'s slice of the packed values (unpadded)."""
        o = int(self.shard_offsets[s])
        return self.layout.values[o: o + int(self.shard_sizes[s])]


def shard_pack_layout(layout: PackLayout, n_shards: int) -> ShardedPackLayout:
    """Partition a pack's values vector into ``n_shards`` contiguous slices.

    Sub-intervals go to shards in pack order by their starting entry: shard
    ``min(S - 1, start * S // footprint)``, so no sub-interval's run is split
    and the slices partition ``values`` exactly; ``base`` is rebased per
    shard so that each slice addresses itself from zero.
    """
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    if n_shards > layout.footprint:
        raise ValueError(
            f"cannot split {layout.footprint} entries into {n_shards} shards")
    F, n_max = layout.n_functions, layout.n_max
    total = layout.footprint
    owner = np.full((F, n_max), -1, dtype=np.int64)
    sizes = np.zeros((n_shards,), dtype=np.int64)
    for f in range(F):
        for j in range(layout.n_intervals[f]):
            start = int(layout.base[f, j])
            s = min(n_shards - 1, start * n_shards // total)
            owner[f, j] = s
            sizes[s] += int(layout.seg_count[f, j]) + 1
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    local_base = np.where(owner >= 0,
                          layout.base - offsets[np.maximum(owner, 0)], 0)
    return ShardedPackLayout(
        layout=layout,
        n_shards=n_shards,
        owner=owner,
        local_base=local_base.astype(np.int64),
        shard_offsets=offsets,
        shard_sizes=sizes,
    )


# --------------------------------------------------------------------------------------
# QuantPack layout — the pack with int8/int16 entry codes + dequant metadata.
# --------------------------------------------------------------------------------------


@dataclass(frozen=True)
class QuantPackLayout:
    """F quantized tables packed into per-width code vectors + flat metadata lanes.

    Unlike :class:`PackLayout`'s (F, n_max)-padded planes, the metadata here is
    RAGGED — flat lanes concatenated per function — because quantization
    refinement (``core.quantize.refine_for_quantization``) gives members very
    different sub-interval counts and padding every plane to the widest member
    would cost more than the quantization saves.  The kernel reads a member's
    lane segment from its offsets (``bounds_offset`` / ``lane_offset``), so
    raggedness is free at run time.

      * ``boundaries``  (sum_f n_f+1,)  per-function rows back to back;
      * ``inv_delta`` / ``base`` / ``seg_count`` / ``scale`` / ``zero`` /
        ``ramp``        (sum_f n_f,)    the selector + dequant lanes;
      * ``codes8``      (M8,) int8-coded entries of every int8 member;
      * ``codes16``     (M16,) likewise for int16 members.

    ``base`` holds GLOBAL indices into the member's own width-group vector.
    Dequantize-on-read: ``v = zero_j + ramp_j * i + scale_j * q``.
    """

    names: Tuple[str, ...]
    members: Tuple[QuantMember, ...]
    n_intervals: Tuple[int, ...]
    entry_bits: Tuple[int, ...]  # 8 or 16 per member (which codes vector)
    boundaries: np.ndarray  # (sum n_f+1,) f64
    inv_delta: np.ndarray  # (sum n_f,) f64
    delta: np.ndarray  # (sum n_f,) f64
    base: np.ndarray  # (sum n_f,) i64 — global into the width-group codes
    seg_count: np.ndarray  # (sum n_f,) i64
    scale: np.ndarray  # (sum n_f,) f64
    zero: np.ndarray  # (sum n_f,) f64
    ramp: np.ndarray  # (sum n_f,) f64
    value_offset: np.ndarray  # (F,) i64 — first codes index within the group
    codes8: np.ndarray  # (M8,) i64 codes of the int8 members, concatenated
    codes16: np.ndarray  # (M16,) i64 codes of the int16 members, concatenated

    @property
    def n_functions(self) -> int:
        return len(self.names)

    @property
    def footprint(self) -> int:
        """Total stored entries (Eq. 13 accounting, width-agnostic)."""
        return int(len(self.codes8) + len(self.codes16))

    @property
    def footprint_bytes(self) -> int:
        """Entry storage bytes — the quantization win vs ``footprint * 4``."""
        return int(len(self.codes8) + 2 * len(self.codes16))

    @property
    def meta_bytes(self) -> int:
        return sum(m.meta_bytes for m in self.members)

    def fn_id(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(
                f"function {name!r} not in pack {self.names}") from None

    def bounds_offset(self, fid: int) -> int:
        return sum(n + 1 for n in self.n_intervals[:fid])

    def lane_offset(self, fid: int) -> int:
        return sum(self.n_intervals[:fid])

    # Routed (dynamic fn_id) dispatch: the per-member offsets above as int32
    # vectors, which the routed kernels gather by fn_id on the device.

    @property
    def bounds_offsets(self) -> np.ndarray:
        """(F,) int32 — per-member start into the flat ``boundaries`` lane."""
        return np.asarray([self.bounds_offset(f) for f in range(self.n_functions)],
                          dtype=np.int32)

    @property
    def lane_offsets(self) -> np.ndarray:
        """(F,) int32 — per-member start into the selector/dequant lanes."""
        return np.asarray([self.lane_offset(f) for f in range(self.n_functions)],
                          dtype=np.int32)

    def eval(self, fn, x: np.ndarray) -> np.ndarray:
        """f64 dequantize-on-read oracle for member ``fn`` (name or fn_id)."""
        fid = self.fn_id(fn) if isinstance(fn, str) else int(fn)
        return self.members[fid].eval(x)


def quant_pack_layout(members: Sequence[QuantMember]) -> QuantPackLayout:
    """Concatenate per-function :class:`QuantMember` artifacts into one layout."""
    if not members:
        raise ValueError("cannot pack zero tables")
    names = tuple(m.name for m in members)
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate function names in pack: {names}")
    boundaries, inv_delta, delta, base, seg_count = [], [], [], [], []
    scale, zero, ramp = [], [], []
    value_offset = np.zeros((len(members),), dtype=np.int64)
    group_acc = {8: 0, 16: 0}
    codes = {8: [], 16: []}
    for f, m in enumerate(members):
        s = m.spec
        boundaries.append(s.boundaries)
        inv_delta.append(s.inv_delta)
        delta.append(s.delta)
        seg_count.append(s.seg_count)
        scale.append(m.scale)
        zero.append(m.zero)
        ramp.append(m.ramp)
        acc = group_acc[m.bits]
        base.append(s.base + acc)
        value_offset[f] = acc
        codes[m.bits].append(m.codes)
        group_acc[m.bits] = acc + m.footprint
    cat = lambda parts: (np.concatenate(parts) if parts
                         else np.zeros((0,), dtype=np.int64))
    return QuantPackLayout(
        names=names,
        members=tuple(members),
        n_intervals=tuple(m.spec.n_intervals for m in members),
        entry_bits=tuple(m.bits for m in members),
        boundaries=np.concatenate(boundaries),
        inv_delta=np.concatenate(inv_delta),
        delta=np.concatenate(delta),
        base=np.concatenate(base),
        seg_count=np.concatenate(seg_count),
        scale=np.concatenate(scale),
        zero=np.concatenate(zero),
        ramp=np.concatenate(ramp),
        value_offset=value_offset,
        codes8=cat(codes[8]),
        codes16=cat(codes[16]),
    )


# --------------------------------------------------------------------------------------
# PolyPack layout — degree-d coefficient packs from the design-space planner.
# --------------------------------------------------------------------------------------


@dataclass(frozen=True)
class PolyPackLayout:
    """F planner-designed :class:`~repro_torch.core.design.PolyMember` tables packed
    into per-width code vectors + flat LANE-PADDED metadata.

    The QuantPack raggedness idea carries over (flat per-function metadata
    lanes, per-member offsets), with two new wrinkles:

      * **Three width groups.**  ``codes8`` / ``codes16`` hold integer codes;
        ``codes32`` holds the f32 members' RAW coefficients.  An f32 member's
        dequant params are pinned to ``zero = ramp = 0, scale = 1``, so the
        one dequant sequence ``(zero + ramp*i) + scale*q`` is a bit-exact
        identity for it — a single kernel op order serves mixed-width packs.

      * **Lane padding to the pack max degree.**  ``zero``/``ramp``/``scale``
        are stored per (sub-interval, lane) with ``max_degree + 1`` lanes for
        EVERY member; a member of lower degree pads the extra lanes with
        zeros.  A padded lane dequantizes to exactly 0.0 (whatever code the
        clipped gather returns, ``0 + 0*i + 0*q = 0``), and a leading zero
        flows through Horner as ``0*t + c_d = c_d`` — so a uniform
        max-degree Horner (the reference's routed kernel) is bitwise
        identical to the member's own degree-d evaluation.

    Codes are cell-major with the member's OWN stride ``degree + 1`` (no code
    padding — storage stays minimal): code of cell ``i``, lane ``l`` of
    sub-interval ``j`` lives at ``base[j] + i*(degree+1) + l`` within the
    member's width group.  Metadata index for (sub-interval ``j``, lane ``l``)
    is ``(lane_offset(fid) + j) * (max_degree+1) + l``.
    """

    names: Tuple[str, ...]
    members: Tuple["PolyMember", ...]
    n_intervals: Tuple[int, ...]
    degrees: Tuple[int, ...]  # interpolation degree per member
    entry_bits: Tuple[int, ...]  # 8 / 16 / 32 per member (which codes vector)
    max_degree: int
    boundaries: np.ndarray  # (sum n_f+1,) f64
    inv_delta: np.ndarray  # (sum n_f,) f64
    delta: np.ndarray  # (sum n_f,) f64
    base: np.ndarray  # (sum n_f,) i64 — global into the width-group codes
    seg_count: np.ndarray  # (sum n_f,) i64
    zero: np.ndarray  # (sum n_f * (max_degree+1),) f64 lane-padded
    ramp: np.ndarray  # (sum n_f * (max_degree+1),) f64 lane-padded
    scale: np.ndarray  # (sum n_f * (max_degree+1),) f64 lane-padded
    value_offset: np.ndarray  # (F,) i64 — first codes index within the group
    codes8: np.ndarray  # (M8,) i64 codes of the int8 members, concatenated
    codes16: np.ndarray  # (M16,) i64 codes of the int16 members
    codes32: np.ndarray  # (M32,) f64 raw coefficients of the f32 members

    @property
    def n_functions(self) -> int:
        return len(self.names)

    @property
    def max_lanes(self) -> int:
        return self.max_degree + 1

    @property
    def footprint(self) -> int:
        """Total stored codes (the planner's entries axis, width-agnostic)."""
        return int(len(self.codes8) + len(self.codes16) + len(self.codes32))

    @property
    def footprint_bytes(self) -> int:
        return int(len(self.codes8) + 2 * len(self.codes16)
                   + 4 * len(self.codes32))

    @property
    def meta_bytes(self) -> int:
        return sum(m.meta_bytes for m in self.members)

    def fn_id(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(
                f"function {name!r} not in pack {self.names}") from None

    def bounds_offset(self, fid: int) -> int:
        return sum(n + 1 for n in self.n_intervals[:fid])

    def lane_offset(self, fid: int) -> int:
        return sum(self.n_intervals[:fid])

    @property
    def bounds_offsets(self) -> np.ndarray:
        """(F,) int32 — per-member start into the flat ``boundaries`` lane."""
        return np.asarray([self.bounds_offset(f) for f in range(self.n_functions)],
                          dtype=np.int32)

    @property
    def lane_offsets(self) -> np.ndarray:
        """(F,) int32 — per-member start into the selector lanes."""
        return np.asarray([self.lane_offset(f) for f in range(self.n_functions)],
                          dtype=np.int32)

    def eval(self, fn, x: np.ndarray) -> np.ndarray:
        """f64 dequantize-on-read Horner oracle for member ``fn``."""
        fid = self.fn_id(fn) if isinstance(fn, str) else int(fn)
        return self.members[fid].eval(x)


def poly_pack_layout(members: Sequence["PolyMember"]) -> PolyPackLayout:
    """Concatenate planner-built :class:`PolyMember` artifacts into one layout."""
    if not members:
        raise ValueError("cannot pack zero tables")
    names = tuple(m.name for m in members)
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate function names in pack: {names}")
    max_degree = max(m.degree for m in members)
    lmax = max_degree + 1
    boundaries, inv_delta, delta, base, seg_count = [], [], [], [], []
    zero, ramp, scale = [], [], []
    value_offset = np.zeros((len(members),), dtype=np.int64)
    group_acc = {8: 0, 16: 0, 32: 0}
    codes = {8: [], 16: [], 32: []}
    for f, m in enumerate(members):
        n = m.n_intervals
        boundaries.append(m.boundaries)
        inv_delta.append(m.inv_delta)
        delta.append(m.delta)
        seg_count.append(m.seg_count)
        # lane-pad the dequant planes to the pack max degree with zeros
        for plane, out in ((m.zero, zero), (m.ramp, ramp), (m.scale, scale)):
            padded = np.zeros((n, lmax), dtype=np.float64)
            padded[:, : m.lanes] = plane
            out.append(padded.ravel())
        acc = group_acc[m.bits]
        base.append(m.base + acc)
        value_offset[f] = acc
        codes[m.bits].append(np.asarray(m.codes, dtype=np.float64)
                             if m.bits == 32 else m.codes)
        group_acc[m.bits] = acc + m.entries
    cat_i = lambda parts: (np.concatenate(parts) if parts
                           else np.zeros((0,), dtype=np.int64))
    cat_f = lambda parts: (np.concatenate(parts) if parts
                           else np.zeros((0,), dtype=np.float64))
    return PolyPackLayout(
        names=names,
        members=tuple(members),
        n_intervals=tuple(m.n_intervals for m in members),
        degrees=tuple(m.degree for m in members),
        entry_bits=tuple(m.bits for m in members),
        max_degree=max_degree,
        boundaries=np.concatenate(boundaries),
        inv_delta=np.concatenate(inv_delta),
        delta=np.concatenate(delta),
        base=np.concatenate(base),
        seg_count=np.concatenate(seg_count),
        zero=np.concatenate(zero),
        ramp=np.concatenate(ramp),
        scale=np.concatenate(scale),
        value_offset=value_offset,
        codes8=cat_i(codes[8]),
        codes16=cat_i(codes[16]),
        codes32=cat_f(codes[32]),
    )
