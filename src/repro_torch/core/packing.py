"""Multi-function pack layout — all of a model's tables as ONE artifact.

The port's copy of ``repro.core.packing``: the f32 :class:`PackLayout`, the
QuantPack layout (int8/int16 codes + ragged dequant metadata), the PolyPack
layout (degree-d coefficient codes, lane-padded dequant metadata) and the
ShardedPack layout (the f32 values vector cut into per-shard slices), and the
paper's future work (Sec. 8): :func:`quantize_table`, one interval-split table
whose entries are stored affinely quantized per sub-interval at the narrowest
width of a menu (the BRAM18 widths, byte widths, or any width up to 36 bits)
that keeps the total error within ``E_a``.

Each layout's ``smem()`` (the reference's pack-level ``vmem()``, TPU VMEM
residency) reports the card's counterpart: the bytes of the staging image
that the flavor's kernels copy into a block's shared memory, in the word
layouts of :mod:`repro_torch.core.bram`, against the 48 KB a block stages,
and what a launch stages (``core.bram.smem_cost_pack``); for a single table,
``core.bram.smem_cost``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional, Sequence, Tuple

import numpy as np

from . import bram
from .functions import FunctionSpec, get as get_function
from .quantize import QuantMember
from .table import TableSpec, build_table

if TYPE_CHECKING:  # for the annotations only: design imports this package
    from .design import PolyMember

BRAM_WIDTHS = (1, 2, 4, 9, 18, 36)  # physical BRAM18 entry widths
INT_WIDTHS = (4, 8, 16, 32)  # byte-aligned storage menu
PACKED_WIDTHS = tuple(range(1, 37))  # arbitrary-width bitfield packing


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

    def values_span(self, members: Sequence[str]) -> Tuple[int, int]:
        """``[v0, v1)``: the values that ``members`` read, from the first
        entry of their first cell to the last of their last (a member
        staging image holds them)."""
        fids = [self.fn_id(n) for n in members]
        ns = [self.n_intervals[f] for f in fids]
        base = np.asarray(self.base, np.int64)
        segs = np.asarray(self.seg_count, np.int64)
        v0 = min(int(base[f, :n].min()) for f, n in zip(fids, ns))
        v1 = max(int((base[f, :n] + segs[f, :n]).max()) for f, n in zip(fids, ns)) + 1
        return v0, v1

    def smem(self, members: Optional[Sequence[str]] = None,
             budget_bytes: int = bram.SMEM_BYTES) -> bram.SmemPackCost:
        """Shared-memory residency of the member staging image over
        ``members`` (``bram.member_image_layout``): the whole pack's
        (``TablePack.image``, which the static and routed f32 kernels stage)
        by default, TableFlash's with ``("exp_neg",)`` (``flash_image``) or
        a fold's with its core members (``fold_images``).  Past the budget a
        launch stages the members' rows at ``n_max`` and the pack's values
        as they fit."""
        names = self.names if members is None else tuple(members)
        v0, v1 = self.values_span(names)
        _, v_at = bram.member_image_layout([self.n_intervals[self.fn_id(n)]
                                            for n in names])
        rows = 1 if members is None else len(names)
        return bram.smem_cost_pack(
            bram._up4(v_at + v1 - v0), 4 * (v1 - v0),
            4 * rows * (4 * self.n_max + 1), 4 * self.footprint, budget_bytes)


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

    def smem(self, shard: Optional[int] = None,
             budget_bytes: int = bram.SMEM_BYTES) -> bram.SmemPackCost:
        """Shared-memory residency of the sharded pack: its staging image
        (``bram.sharded_image_layout``: every member's rows and the S padded
        values slices, ``ShardedTablePack.image``), which the grads stage
        over all the shards where it fits.  The value kernels take the
        fallback: the member's five rows at ``n_max`` and the values slab of
        their shard range, all S slices (``shard=None``) or one
        (``shard=k``, one shard's contribution; every slice is padded to the
        same length)."""
        S, m = self.n_shards, self.max_shard_entries
        if shard is not None and not 0 <= shard < S:
            raise IndexError(f"shard {shard} out of range for {S} shards")
        words = bram.sharded_image_layout(self.n_intervals, S, m)[2]
        span = S if shard is None else 1
        return bram.smem_cost_pack(words, 4 * S * m,
                                   4 * bram._up4(5 * self.layout.n_max + 1),
                                   4 * m * span, budget_bytes)


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

    def smem(self, budget_bytes: int = bram.SMEM_BYTES) -> bram.SmemPackCost:
        """Shared-memory residency of the quantized pack's staging image
        (``bram.quant_image_layout``: the routing operands, the seven
        metadata lanes and both code groups, ``QuantTablePack.image``),
        which the static and routed quant kernels stage where it fits.  Past
        the budget a launch stages the widest member's seven lanes and the
        larger code group as they fit.  An empty width group keeps its
        1-entry dummy, as the pack stores it."""
        m8, m16 = max(len(self.codes8), 1), max(len(self.codes16), 1)
        _, words = bram.quant_image_layout(self.n_functions, len(self.inv_delta),
                                           m8, m16)
        max_n = max(self.n_intervals)
        return bram.smem_cost_pack(
            words, 4 * ((m16 + 1) // 2 + (m8 + 3) // 4), 4 * (7 * max_n + 1),
            max(m8, 2 * m16), budget_bytes)

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

    def smem(self, budget_bytes: int = bram.SMEM_BYTES) -> bram.SmemPackCost:
        """Shared-memory residency of the polynomial pack's staging image
        (``bram.poly_image_layout``: the routing operands, the metadata
        lanes, the lane-padded dequant lanes and the three code groups,
        ``PolyTablePack.image``), which the static and routed poly kernels
        stage where it fits.  Past the budget a launch stages the widest
        member's lanes and the largest code group as they fit.  An empty
        width group keeps its 1-entry dummy, as the pack stores it."""
        m8, m16, m32 = (max(len(c), 1) for c in (self.codes8, self.codes16,
                                                 self.codes32))
        lanes, max_n = self.max_lanes, max(self.n_intervals)
        _, words = bram.poly_image_layout(self.n_functions, len(self.inv_delta),
                                          lanes, m8, m16, m32)
        return bram.smem_cost_pack(
            words, 4 * (m32 + (m16 + 1) // 2 + (m8 + 3) // 4),
            4 * (4 * max_n + 1 + 3 * max_n * lanes), max(m8, 2 * m16, 4 * m32),
            budget_bytes)

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


@dataclass(frozen=True)
class QuantizedTableSpec:
    """A TableSpec whose values are stored affinely quantized per sub-interval."""

    base: TableSpec
    q_values: np.ndarray  # (M_F,) int64 codes
    scale: np.ndarray  # (n,) f64 per sub-interval
    zero: np.ndarray  # (n,) f64 per sub-interval
    bits: np.ndarray  # (n,) i64 chosen width per sub-interval
    rho: float

    @property
    def footprint_bits(self) -> int:
        counts = np.diff(np.concatenate([self.base.base,
                                         [self.base.footprint]]))
        return int(np.sum(counts * self.bits))

    @property
    def footprint_bits_fp32(self) -> int:
        return 32 * self.base.footprint

    @property
    def bit_reduction(self) -> float:
        return 1.0 - self.footprint_bits / self.footprint_bits_fp32

    def eval(self, x: np.ndarray) -> np.ndarray:
        """Dequantize-on-read evaluation (the hardware path)."""
        ts = self.base
        x = np.asarray(x, dtype=np.float64)
        j = np.clip(np.searchsorted(ts.boundaries, x, side="right") - 1,
                    0, ts.n_intervals - 1)
        p_j = ts.boundaries[j]
        i = np.clip(np.floor((x - p_j) * ts.inv_delta[j]).astype(np.int64),
                    0, ts.seg_count[j] - 1)
        a = ts.base[j] + i
        y0 = self.zero[j] + self.scale[j] * self.q_values[a]
        y1 = self.zero[j] + self.scale[j] * self.q_values[a + 1]
        t = np.clip((x - (p_j + i * ts.delta[j])) * ts.inv_delta[j], 0.0, 1.0)
        return y0 + t * (y1 - y0)

    def max_error_on_grid(self, fn: Optional[FunctionSpec] = None,
                          n: int = 100_001) -> float:
        fn = fn or get_function(self.base.name)
        xs = np.linspace(self.base.lo, self.base.hi, n)
        xs = xs[xs < self.base.hi]
        return float(np.max(np.abs(self.eval(xs) - np.asarray(fn.f(xs)))))


def _min_width(value_range: float, tol: float, menu: Tuple[int, ...]) -> int:
    """Smallest menu width b with (range / (2^b - 1)) / 2 <= tol."""
    for b in menu:
        if b >= 63:
            return b
        if value_range <= 2.0 * tol * (2**b - 1):
            return b
    return menu[-1]


def quantize_table(
    fn: FunctionSpec | str,
    e_a: float,
    lo: Optional[float] = None,
    hi: Optional[float] = None,
    algorithm: str = "hierarchical",
    omega: float = 0.3,
    *,
    rho: float = 0.8,
    width_menu: Tuple[int, ...] = PACKED_WIDTHS,
) -> QuantizedTableSpec:
    """Build an interval-split table at rho*Ea and quantize each sub-interval's
    entries at the minimal width keeping total error <= Ea."""
    if not (0.0 < rho < 1.0):
        raise ValueError("rho must be in (0, 1)")
    fn = get_function(fn) if isinstance(fn, str) else fn
    ts = build_table(fn, rho * e_a, lo, hi, algorithm=algorithm, omega=omega)
    tol = (1.0 - rho) * e_a
    counts = np.diff(np.concatenate([ts.base, [ts.footprint]]))
    q = np.zeros(ts.footprint, dtype=np.int64)
    scale = np.zeros(ts.n_intervals)
    zero = np.zeros(ts.n_intervals)
    bits = np.zeros(ts.n_intervals, dtype=np.int64)
    for jj in range(ts.n_intervals):
        s0, s1 = int(ts.base[jj]), int(ts.base[jj] + counts[jj])
        vals = ts.values[s0:s1]
        vmin, vmax = float(vals.min()), float(vals.max())
        b = _min_width(vmax - vmin, tol, width_menu)
        levels = 2**b - 1
        s = (vmax - vmin) / levels if vmax > vmin else 1.0
        codes = np.clip(np.rint((vals - vmin) / s), 0, levels)
        q[s0:s1] = codes.astype(np.int64)
        scale[jj], zero[jj], bits[jj] = s, vmin, b
    return QuantizedTableSpec(base=ts, q_values=q, scale=scale, zero=zero,
                              bits=bits, rho=rho)
