"""TablePack — every table a model needs, fused into ONE device artifact (the
f32, quantized, polynomial and sharded parts of the JAX package's
``approx/table_pack.py``; the sharded pack off the mesh).

The paper keeps each function's table resident in BRAM next to its consumer
(Sec. 7.2); a network evaluates a *set* of nonlinearities, so a
:class:`TablePack` concatenates all range values into a single ``values``
vector and stores the selector metadata as (F, n_max) padded planes (see
:class:`repro_torch.core.packing.PackLayout`).  ONE artifact stays on the
device for the whole network, and ONE kernel — :mod:`repro_torch.kernels.
table_pack_lookup` — serves any member through its ``fn_id`` row.

``eval_pack_ref`` is the plain PyTorch lookup: bit-identical to the JAX
package's eager ``eval_pack_ref`` and to the CUDA kernel.

:class:`QuantTablePack` stores int8/int16 entry codes dequantized on read
and :class:`PolyTablePack` the planner's degree-1..3 coefficient codes
evaluated by Horner, both over ragged per-member metadata lanes; their plain
lookups (``eval_quant_pack_ref``, ``eval_poly_pack_ref`` and the slopes) are
bit-identical to the JAX package's eager oracles and to the CUDA kernels.
:class:`ShardedTablePack` cuts the f32 values vector into per-shard slices;
each shard's masked contribution (``shard_contrib_ref``) is summed in shard
order on one device (``eval_sharded_ref``, ``eval_sharded_slope``).

``make_pack_fn``, ``make_quant_pack_fn``, ``make_poly_pack_fn``,
``make_sharded_pack_fn`` and ``make_attn_exp_fn`` are differentiable through
:func:`~repro_torch.approx.torch_table.slope_rule`: under a gradient the
forward runs the fused value + slope kernel (``table_pack_grad``,
``quant_pack_grad``, ``poly_pack_grad``, ``sharded_pack_grad``) and the
backward multiplies the saved slope into the incoming gradient.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bram import (POLY_IMAGE_SECTIONS, QUANT_IMAGE_SECTIONS,
                                  member_image_layout, poly_image_layout,
                                  quant_image_layout, sharded_image_layout)
from repro_torch.core.flow import cached_table
from repro_torch.core.packing import (PackLayout, PolyPackLayout, QuantPackLayout,
                                     ShardedPackLayout, pack_layout,
                                     poly_pack_layout, quant_pack_layout,
                                     shard_pack_layout)
from repro_torch.core.quantize import plan_quant_member
from repro_torch.core.table import TableSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.sharding import axis_sizes, current_mesh

from .torch_table import (EXACT_INT_LIMIT, clamp_cell, f32_tensor, lane_address,
                          lookup_rows, pair_address, select_interval,
                          slope_rows, slope_rule)


def _member_id(names: Tuple[str, ...], fn) -> int:
    """Resolve a name or integer fn_id to a VALIDATED member index.

    Unknown names and out-of-range integers both raise ``KeyError`` naming the
    offender and listing the registered members.
    """
    if isinstance(fn, str):
        try:
            return names.index(fn)
        except ValueError:
            raise KeyError(f"function {fn!r} not in pack {names}") from None
    fid = int(fn)
    if not 0 <= fid < len(names):
        raise KeyError(
            f"fn_id {fid} out of range for pack with {len(names)} members "
            f"{names}") from None
    return fid


@dataclass(frozen=True)
class TablePack:
    """Device-ready multi-function table artifact (all tensors f32 on one
    device, contiguous — the layout the CUDA kernels read)."""

    names: Tuple[str, ...]  # member function names (fn_id order)
    n_intervals: Tuple[int, ...]  # real sub-interval count per member
    boundaries: torch.Tensor  # (F, n_max+1) f32, right-padded +inf
    inv_delta: torch.Tensor  # (F, n_max)   f32
    delta: torch.Tensor  # (F, n_max)   f32
    base: torch.Tensor  # (F, n_max)   f32 — GLOBAL packed-values index (exact < 2^24)
    seg_count: torch.Tensor  # (F, n_max)   f32
    values: torch.Tensor  # (M,)         f32 — all member tables, concatenated
    # member domains [lo, hi) on the host, read once at build time (the
    # TableFlash zero tail needs lo as a plain number, not a device read)
    domains: Tuple[Tuple[float, float], ...]
    # routed dispatch's per-member int32 operands on the pack's device, built
    # once with the pack: (n_arr,), see routing_scalars()
    routing: Tuple[torch.Tensor, ...]
    # the whole pack's staging image (every member's row over its real
    # sub-intervals, then the values; member_image_layout over all the
    # names) and the values it holds, built once with the pack: what a block
    # of the routed and of the static value and grad kernels stages where it
    # fits.  Its values start at the pack's first entry (the first member's
    # base is 0), so its bases are the pack's own
    image: Tuple[torch.Tensor, int]
    # each member's row start in ``image`` (int32, on the pack's device):
    # the routed kernels gather it by fn_id beside n_arr
    image_rows: torch.Tensor
    # per-member extrapolate flag vectors on the device, one per distinct
    # flag tuple (routed_extr_operand)
    _extr_operands: Dict[bytes, torch.Tensor] = field(
        default_factory=dict, compare=False, repr=False)
    # RangeFold's staging images on the pack's device, built once with the
    # pack: foldable name -> (image, values it holds), for every foldable
    # name whose core members the pack holds (sin and cos share one image);
    # see member_image_layout
    fold_images: Dict[str, Tuple[torch.Tensor, int]] = field(
        default_factory=dict, compare=False, repr=False)
    # TableFlash's staging image (exp_neg's row and values) and the values it
    # holds, built once with the pack; None without an exp_neg member
    flash_image: Optional[Tuple[torch.Tensor, int]] = field(
        default=None, compare=False, repr=False)

    def routing_scalars(self) -> Tuple[torch.Tensor, ...]:
        """The routed kernels' per-member operands, gathered by fn_id on the
        device: ``(n_arr,)`` with ``n_arr[f]`` member f's real sub-interval
        count (int32, on the pack's device)."""
        return self.routing

    @property
    def n_functions(self) -> int:
        return len(self.names)

    @property
    def n_max(self) -> int:
        return self.inv_delta.shape[1]

    @property
    def footprint(self) -> int:
        return self.values.shape[0]

    @property
    def device(self) -> torch.device:
        return self.values.device

    def fn_id(self, name: str) -> int:
        return _member_id(self.names, name)

    def member_id(self, fn) -> int:
        """Name or integer fn_id -> validated index (KeyError otherwise)."""
        return _member_id(self.names, fn)


def _int32_tensor(values, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, dtype=np.int32)).to(device)


def _row_domains(layout: PackLayout) -> Tuple[Tuple[float, float], ...]:
    """Each member's [lo, hi) as host floats of its f32 boundary row."""
    b = np.asarray(layout.boundaries, np.float64).astype(np.float32)
    return tuple((float(b[f, 0]), float(b[f, n]))
                 for f, n in enumerate(layout.n_intervals))


# foldable member -> the core members its reconstruction reads (RangeFold,
# approx/range_fold.py)
FOLDABLE = {
    "sin": ("sin_core", "cos_core"),
    "cos": ("sin_core", "cos_core"),
    "exp": ("exp_core",),
    "log": ("log_core",),
}


def _member_image(layout: PackLayout, members: Sequence[str], dev: torch.device):
    """The staging image of ``members`` (member_image_layout): what a kernel
    that reads only those members reads of the pack and nothing else.  Their
    rows (only the real sub-intervals: a scan of the +inf padding never
    moves the selector), each base rebased into the image, then their values
    from the first member's first entry to the end of the last cell,
    zero-padded to a 16-byte multiple so that one bulk copy stages it.
    Returns (f32 image on ``dev``, values it holds)."""
    f32 = lambda a: np.asarray(a, np.float64).astype(np.float32)
    fids = [layout.names.index(c) for c in members]
    ns = [layout.n_intervals[f] for f in fids]
    base = np.asarray(layout.base, np.int64)
    segs = np.asarray(layout.seg_count, np.int64)
    v0, v1 = layout.values_span(members)
    starts, v_at = member_image_layout(ns)
    img = np.zeros(-(-(v_at + v1 - v0) // 4) * 4, np.float32)
    for f, n, at in zip(fids, ns, starts):
        img[at: at + 4 * n + 1] = np.concatenate(
            [f32(layout.boundaries[f, : n + 1]), f32(layout.inv_delta[f, :n]),
             f32(base[f, :n] - v0), f32(segs[f, :n])])
    img[v_at: v_at + v1 - v0] = f32(layout.values[v0:v1])
    return torch.from_numpy(img).to(dev), v1 - v0


def _fold_images(layout: PackLayout, dev: torch.device):
    """fold_images of a pack: one image for each set of cores it holds."""
    images, by_cores = {}, {}
    for name, cores in FOLDABLE.items():
        if all(c in layout.names for c in cores):
            if cores not in by_cores:
                by_cores[cores] = _member_image(layout, cores, dev)
            images[name] = by_cores[cores]
    return images


def from_layout(layout: PackLayout, device: DeviceLike = None) -> TablePack:
    if layout.footprint >= EXACT_INT_LIMIT:
        raise ValueError("pack footprint exceeds f32 exact-integer range")
    dev = resolve_device(device)
    return TablePack(
        names=layout.names,
        n_intervals=layout.n_intervals,
        boundaries=f32_tensor(layout.boundaries, dev),
        inv_delta=f32_tensor(layout.inv_delta, dev),
        delta=f32_tensor(layout.delta, dev),
        base=f32_tensor(layout.base, dev),
        seg_count=f32_tensor(layout.seg_count, dev),
        values=f32_tensor(layout.values, dev),
        domains=_row_domains(layout),
        routing=(_int32_tensor(layout.n_intervals, dev),),
        image=_member_image(layout, layout.names, dev),
        image_rows=_int32_tensor(member_image_layout(layout.n_intervals)[0], dev),
        fold_images=_fold_images(layout, dev),
        flash_image=(_member_image(layout, ("exp_neg",), dev)
                     if "exp_neg" in layout.names else None),
    )


def pack_specs(specs: Sequence[TableSpec], device: DeviceLike = None) -> TablePack:
    """Pack already-built TableSpecs (order defines fn_id)."""
    return from_layout(pack_layout(specs), device)


def build_pack(
    names: Sequence[str],
    e_a: float,
    *,
    algorithm: str = "hierarchical",
    omega: float = 0.3,
    intervals: Optional[dict] = None,
    device: DeviceLike = None,
) -> TablePack:
    """Run the design flow for every name and fuse the artifacts into one pack."""
    intervals = intervals or {}
    specs = []
    for name in names:
        lo, hi = intervals.get(name, (None, None))
        specs.append(cached_table(name, e_a, lo, hi, algorithm=algorithm,
                                  omega=omega))
    return pack_specs(specs, device)


def eval_pack_ref(pack: TablePack, fn, x: torch.Tensor, *,
                  extrapolate: bool = False) -> torch.Tensor:
    """Plain PyTorch pack evaluation — bit-identical to the JAX package's
    eager ``eval_pack_ref`` and to the per-table ``eval_table_ref``."""
    fid = pack.member_id(fn)
    return lookup_rows(pack.boundaries[fid], pack.inv_delta[fid],
                       pack.base[fid], pack.seg_count[fid],
                       pack.n_intervals[fid], pack.values, x,
                       extrapolate=extrapolate)


def eval_pack_slope(pack: TablePack, fn, x: torch.Tensor, *,
                    extrapolate: bool = False) -> torch.Tensor:
    """d/dx of the pack surrogate — bit-identical to ``eval_table_slope``."""
    fid = pack.member_id(fn)
    return slope_rows(pack.boundaries[fid], pack.inv_delta[fid],
                      pack.base[fid], pack.seg_count[fid],
                      pack.n_intervals[fid], pack.values, x,
                      extrapolate=extrapolate)


def member_domain(pack: TablePack, fn) -> Tuple[float, float]:
    """Member ``fn``'s table domain ``[lo, hi)`` (host floats of the f32
    boundaries).  Inputs outside it hit the hardware clamp, or the linear
    edge extrapolation for the ``_EXTRAPOLATE`` activations."""
    return pack.domains[pack.member_id(fn)]


def _make_fn(pack, name: str, lookup, grad, exact_d1, extrapolate: bool):
    """The autograd wiring the three ``make_*_fn`` share: value path
    ``lookup(pack, fid, x)``, fused value + slope ``grad(pack, fid, x)``
    (or the value and ``exact_d1(x)`` when given), joined by ``slope_rule``."""
    fid = pack.fn_id(name)
    value = lambda v: lookup(pack, fid, v, extrapolate=extrapolate)
    if exact_d1 is not None:
        fused = lambda v: (value(v), exact_d1(v))
    else:
        fused = lambda v: grad(pack, fid, v, extrapolate=extrapolate)
    return slope_rule(value, fused)


def make_pack_fn(pack: TablePack, name: str, *, use_kernel: bool = True,
                 exact_d1=None, extrapolate: bool = False):
    """Differentiable unary ``f(x)`` evaluated through the shared pack.

    ``use_kernel=True`` routes through the CUDA kernel wrappers
    (``table_pack`` mode), which run the plain versions only for a tensor on
    the CPU: ``table_pack_lookup`` without a gradient, the fused value + slope
    ``table_pack_grad`` under one.  ``use_kernel=False`` is the plain version
    everywhere (``table_pack_ref``).  Tangent: the table slope, or
    ``exact_d1(x)`` when given (then the forward is the value path).
    """
    from repro_torch.kernels import table_pack_lookup as K

    fns = ((K.table_pack_lookup, K.table_pack_grad) if use_kernel
           else (K.table_pack_lookup_plain, K.table_pack_grad_plain))
    return _make_fn(pack, name, *fns, exact_d1, extrapolate)


def make_attn_exp_fn(pack: TablePack, *, use_kernel: bool = True):
    """TableFlash exponent: ``exp(z)`` for z <= 0 served from ``exp_neg``.

    The closure flash attention threads as ``exp_fn`` (see
    ``models.attention._flash_inner``).  Both running-softmax arguments are
    non-positive by construction, so the member's [lo, 0] domain covers them,
    with an UNDERFLOW-TO-ZERO tail below lo: returning exactly 0.0 there
    matches f32 ``exp``'s own underflow for the hugely negative masked-key
    arguments, so masked, empty and pad slots carry weight 0 in both the
    exact and the table path.  The address math still clamps at lo; the zero
    select is on the raw z.  Fused in the CUDA kernel
    (:func:`~repro_torch.kernels.table_pack_lookup.tableflash_exp`), explicit
    in its plain version.

    Tangent: the member's table slope at the RAW z with extrapolation off
    (zero outside [lo, 0), so the constant zero tail has slope 0), as the
    reference's ``eval_pack_slope(pack, fid, z)``.  With ``use_kernel`` it is
    the slope output of ``table_pack_grad`` (the same function, bit for bit),
    so no plain version runs on the card's training path.
    """
    from repro_torch.kernels.table_pack_lookup import (table_pack_grad,
                                                       tableflash_exp,
                                                       tableflash_exp_plain)

    fid = pack.fn_id("exp_neg")  # KeyError now, not at the first attention call
    if use_kernel:
        value = lambda v: tableflash_exp(pack, v)
        slope = lambda v: table_pack_grad(pack, fid, v)[1]
    else:
        value = lambda v: tableflash_exp_plain(pack, v)
        slope = lambda v: eval_pack_slope(pack, fid, v)
    return slope_rule(value, lambda v: (value(v), slope(v)))


# --------------------------------------------------------------------------------------
# QuantPack — the pack with int8/int16 entry codes, dequantized on read.
# --------------------------------------------------------------------------------------


_NP_CODES = {torch.int8: np.int8, torch.int16: np.int16, torch.float32: np.float32}


def _codes_array(codes: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """A width group's codes as stored; an empty group keeps a 1-entry dummy
    so that the operand stays valid, as in the reference."""
    if len(codes) == 0:
        return np.zeros((1,), dtype=_NP_CODES[dtype])
    return np.asarray(codes).astype(_NP_CODES[dtype])


def _check_exact(*groups: np.ndarray) -> None:
    if max(len(g) for g in groups) >= EXACT_INT_LIMIT:
        raise ValueError("pack footprint exceeds f32 exact-integer range")


def _pack_image(layout, sections, starts, total, routing, codes,
                dev: torch.device) -> torch.Tensor:
    """The int32 staging image of a quantized or polynomial pack, ``total``
    words on ``dev``, each of ``sections`` at its start: the pack's int32
    ``routing`` operands, then the layout's f32 planes of the sections'
    names, then its ``codes`` groups as stored."""
    f32 = lambda a: np.asarray(a, np.float64).astype(np.float32)
    planes = sections[len(routing): len(sections) - len(codes)]
    parts = (tuple(np.asarray(r, np.int32) for r in routing)
             + tuple(f32(getattr(layout, p)) for p in planes) + tuple(codes))
    img = np.zeros(total * 4, np.uint8)
    for name, part in zip(sections, parts):
        raw = np.ascontiguousarray(part).view(np.uint8)
        img[4 * starts[name]: 4 * starts[name] + raw.size] = raw
    return torch.from_numpy(img.view(np.int32)).to(dev)


class _RaggedPack:
    """What the quantized and polynomial packs share: member lookup, the
    ragged per-member offsets into the flat metadata lanes, and the width
    group a member's codes live in."""

    @property
    def n_functions(self) -> int:
        return len(self.names)

    @property
    def device(self) -> torch.device:
        return self.boundaries.device

    def fn_id(self, name: str) -> int:
        return _member_id(self.names, name)

    def member_id(self, fn) -> int:
        """Name or integer fn_id -> validated index (KeyError otherwise)."""
        return _member_id(self.names, fn)

    def bounds_offset(self, fid: int) -> int:
        """Start of member ``fid``'s ``n + 1`` boundaries in the flat lane."""
        return sum(n + 1 for n in self.n_intervals[:fid])

    def lane_offset(self, fid: int) -> int:
        """Start of member ``fid``'s ``n`` selector/dequant lanes."""
        return sum(self.n_intervals[:fid])

    def _groups(self):
        return {8: self.codes8, 16: self.codes16}

    def codes_for(self, fid: int) -> torch.Tensor:
        return self._groups()[self.entry_bits[fid]]

    @property
    def footprint(self) -> int:
        """Stored entries — excludes the 1-entry dummy of an unused width
        group, so it agrees with the layout's accounting."""
        return sum(c.shape[0] for bits, c in self._groups().items()
                   if bits in self.entry_bits)

    @property
    def footprint_bytes(self) -> int:
        return sum(c.shape[0] * c.element_size()
                   for bits, c in self._groups().items() if bits in self.entry_bits)


@dataclass(frozen=True)
class QuantTablePack(_RaggedPack):
    """Device-ready quantized multi-function pack (the reference's
    ``QuantTablePack``).

    Entries live as int8/int16 codes in two width-group vectors; the selector
    metadata plus per-sub-interval dequant params (scale, zero, ramp) are flat
    RAGGED f32 lanes — member ``fid``'s segment starts at ``bounds_offset`` /
    ``lane_offset`` (see :class:`repro_torch.core.packing.QuantPackLayout`).
    Dequantize-on-read: ``v = (zero + ramp*i) + scale*q``.
    """

    names: Tuple[str, ...]  # member function names (fn_id order)
    n_intervals: Tuple[int, ...]  # sub-interval count per member
    entry_bits: Tuple[int, ...]  # 8 | 16 → which codes vector
    rho: Tuple[float, ...]  # interpolation share of e_a per member
    boundaries: torch.Tensor  # (sum n_f+1,) f32 flat rows
    inv_delta: torch.Tensor  # (sum n_f,) f32
    base: torch.Tensor  # (sum n_f,) f32 — GLOBAL index into the width-group codes
    seg_count: torch.Tensor  # (sum n_f,) f32
    scale: torch.Tensor  # (sum n_f,) f32
    zero: torch.Tensor  # (sum n_f,) f32
    ramp: torch.Tensor  # (sum n_f,) f32
    codes8: torch.Tensor  # (max(M8,1),) int8
    codes16: torch.Tensor  # (max(M16,1),) int16
    domains: Tuple[Tuple[float, float], ...]  # member [lo, hi) on the host
    # routed dispatch's per-member int32 operands on the pack's device, built
    # once with the pack: see routing_scalars()
    routing: Tuple[torch.Tensor, ...]
    # the whole pack (routing operands, metadata lanes, both code groups) as
    # ONE int32 buffer on the pack's device, built once with the pack: what a
    # block of the routed and of the static kernels stages where it fits
    # (quant_image_layout)
    image: torch.Tensor
    _extr_operands: Dict[bytes, torch.Tensor] = field(
        default_factory=dict, compare=False, repr=False)

    def routing_scalars(self) -> Tuple[torch.Tensor, ...]:
        """The routed kernels' per-member operands, gathered by fn_id on the
        device: ``(n_arr, bounds_offsets, lane_offsets, entry_bits)``, int32
        vectors on the pack's device (the reference's ragged offsets and
        width-group choice)."""
        return self.routing


def _domains(layout) -> Tuple[Tuple[float, float], ...]:
    b = np.asarray(layout.boundaries, np.float64).astype(np.float32)
    out, off = [], 0
    for n in layout.n_intervals:
        out.append((float(b[off]), float(b[off + n])))
        off += n + 1
    return tuple(out)


def from_quant_layout(layout: QuantPackLayout,
                      device: DeviceLike = None) -> QuantTablePack:
    _check_exact(layout.codes8, layout.codes16)
    dev = resolve_device(device)
    f32 = lambda a: f32_tensor(a, dev)
    routing = (layout.n_intervals, layout.bounds_offsets, layout.lane_offsets,
               layout.entry_bits)
    codes = (_codes_array(layout.codes8, torch.int8),
             _codes_array(layout.codes16, torch.int16))
    return QuantTablePack(
        names=layout.names,
        n_intervals=layout.n_intervals,
        entry_bits=layout.entry_bits,
        rho=tuple(m.rho for m in layout.members),
        boundaries=f32(layout.boundaries),
        inv_delta=f32(layout.inv_delta),
        base=f32(layout.base),
        seg_count=f32(layout.seg_count),
        scale=f32(layout.scale),
        zero=f32(layout.zero),
        ramp=f32(layout.ramp),
        codes8=torch.from_numpy(codes[0]).to(dev),
        codes16=torch.from_numpy(codes[1]).to(dev),
        domains=_domains(layout),
        routing=tuple(_int32_tensor(v, dev) for v in routing),
        image=_pack_image(
            layout, QUANT_IMAGE_SECTIONS,
            *quant_image_layout(len(layout.names), len(layout.inv_delta),
                                *(len(c) for c in codes)), routing, codes[::-1], dev),
    )


def build_quant_pack(
    names: Sequence[str],
    e_a: float,
    *,
    rho: float = 0.9,
    dtype: str = "auto",
    algorithm: str = "hierarchical",
    omega: float = 0.3,
    intervals: Optional[dict] = None,
    device: DeviceLike = None,
) -> QuantTablePack:
    """Error-budgeted quantized pack: interpolation gets ``rho * e_a``, code
    rounding the rest; int8 vs int16 is chosen per member (``dtype='auto'``)."""
    intervals = intervals or {}
    members = []
    for name in names:
        lo, hi = intervals.get(name, (None, None))
        members.append(plan_quant_member(
            name, e_a, lo, hi, algorithm=algorithm, omega=omega,
            rho=rho, dtype=dtype))
    return from_quant_layout(quant_pack_layout(members), device)


def _ragged_select(pack, fid: int, xf: torch.Tensor, planes):
    """Comparator plane over member ``fid``'s boundary row, then one gather
    per plane of its lane segment."""
    bo, lo = pack.bounds_offset(fid), pack.lane_offset(fid)
    n = pack.n_intervals[fid]
    brow = pack.boundaries[bo: bo + n + 1]
    j = select_interval(brow, n, xf)
    return j, brow[j], [plane[lo: lo + n][j] for plane in planes]


def _quant_select(pack: QuantTablePack, fid: int, xf: torch.Tensor):
    """Selector + seven gathers against member ``fid``'s ragged lane segment."""
    _, p, (invd, base, segs, scale, zero, ramp) = _ragged_select(
        pack, fid, xf, (pack.inv_delta, pack.base, pack.seg_count, pack.scale,
                        pack.zero, pack.ramp))
    return p, invd, base, segs, scale, zero, ramp


def _inside(pack, fid: int, xf: torch.Tensor) -> torch.Tensor:
    """The 0/1 indicator of member ``fid``'s domain [b_0, b_n), in f32."""
    bo, n = pack.bounds_offset(fid), pack.n_intervals[fid]
    return ((xf >= pack.boundaries[bo]) & (xf < pack.boundaries[bo + n])).to(
        torch.float32)


def _quant_codes(pack: QuantTablePack, fid: int, base, i):
    """The cell's endpoint codes, in f32, from the member's width group."""
    codes = pack.codes_for(fid)
    a0, a1 = pair_address(base, i, codes.shape[0])
    return codes[a0].to(torch.float32), codes[a1].to(torch.float32)


def eval_quant_pack_ref(pack: QuantTablePack, fn, x: torch.Tensor, *,
                        extrapolate: bool = False) -> torch.Tensor:
    """Plain PyTorch dequantize-on-read lookup — bit-identical to the JAX
    package's eager ``eval_quant_pack_ref`` and to the CUDA kernel."""
    fid = pack.member_id(fn)
    dtype = x.dtype
    xf = x.to(torch.float32)
    p, invd, base, segs, scale, zero, ramp = _quant_select(pack, fid, xf)
    u = (xf - p) * invd
    i = clamp_cell(u, segs)
    c0, c1 = _quant_codes(pack, fid, base, i)
    r = zero + ramp * i  # the chord ramp at entry i
    y0 = r + scale * c0
    y1 = (r + ramp) + scale * c1
    t = u - i
    if not extrapolate:
        t = torch.clamp(t, 0.0, 1.0)
    return (y0 + t * (y1 - y0)).to(dtype)


def eval_quant_pack_slope(pack: QuantTablePack, fn, x: torch.Tensor, *,
                          extrapolate: bool = False) -> torch.Tensor:
    """d/dx of the quantized surrogate: (ramp + scale * (c1 - c0)) / delta,
    zeroed outside [b_0, b_n) unless extrapolating."""
    fid = pack.member_id(fn)
    dtype = x.dtype
    xf = x.to(torch.float32)
    p, invd, base, segs, scale, zero, ramp = _quant_select(pack, fid, xf)
    i = clamp_cell((xf - p) * invd, segs)
    c0, c1 = _quant_codes(pack, fid, base, i)
    slope = (ramp + scale * (c1 - c0)) * invd
    if not extrapolate:
        slope = slope * _inside(pack, fid, xf)
    return slope.to(dtype)


def make_quant_pack_fn(pack: QuantTablePack, name: str, *,
                       use_kernel: bool = True, exact_d1=None,
                       extrapolate: bool = False):
    """Differentiable unary ``f(x)`` served from the quantized pack.

    Mirrors :func:`make_pack_fn`: ``use_kernel=True`` (``quant_pack``) runs
    the CUDA kernels — ``quant_pack_lookup`` without a gradient, the fused
    value + slope ``quant_pack_grad`` under one — and ``use_kernel=False``
    (``quant_pack_ref``) the plain versions.  Tangent: the quantized table's
    slope, or ``exact_d1(x)`` when given.
    """
    from repro_torch.kernels import table_pack_lookup as K

    fns = ((K.quant_pack_lookup, K.quant_pack_grad) if use_kernel
           else (K.quant_pack_lookup_plain, K.quant_pack_grad_plain))
    return _make_fn(pack, name, *fns, exact_d1, extrapolate)


def quant_saturation_counts(pack: QuantTablePack, fn, x: torch.Tensor):
    """(saturated, total) endpoint-code gathers member ``fn`` performs on ``x``
    (the reference's ``quant_saturation_counts``): ``saturated`` a 0-d int64
    tensor on x's device, no host sync; ``total == 2 * x.numel()``.

    A gathered code at the signed extreme of its width (|c| >= 127 for int8,
    >= 32767 for int16) means the per-sub-interval affine quantizer clipped
    that entry, so the saturation rate is the telemetry's quant health
    signal.  The addresses are the plain version's own (``_quant_select``,
    ``pair_address``): each lookup gathers the chord's two endpoint codes.
    """
    fid = pack.member_id(fn)
    xf = x.to(torch.float32)
    p, invd, base, segs, _, _, _ = _quant_select(pack, fid, xf)
    i = clamp_cell((xf - p) * invd, segs)
    codes = pack.codes_for(fid)
    a0, a1 = pair_address(base, i, codes.shape[0])
    qmax = 127 if pack.entry_bits[fid] == 8 else 32767
    sat = ((codes[a0].to(torch.int32).abs() >= qmax).sum()
           + (codes[a1].to(torch.int32).abs() >= qmax).sum())
    return sat, 2 * xf.numel()


# --------------------------------------------------------------------------------------
# PolyPack — planner-designed degree-d coefficient packs, Horner-evaluated on read.
# --------------------------------------------------------------------------------------


@dataclass(frozen=True)
class PolyTablePack(_RaggedPack):
    """Device-ready polynomial multi-function pack (the reference's
    ``PolyTablePack``).

    Member ``fid`` stores ``degree + 1`` coefficient codes per cell in one of
    THREE width-group vectors — ``codes8``/``codes16`` (integer codes) or
    ``codes32`` (the f32 members' raw coefficients, carried through the same
    dequant with ``zero = ramp = 0, scale = 1``, a bit-exact identity).  The
    per-sub-interval dequant params are lane-padded to ``max_degree + 1``
    lanes for every member (see :class:`repro_torch.core.packing.
    PolyPackLayout`); the metadata index of (sub-interval ``j``, lane ``l``)
    is ``(lane_offset + j) * max_lanes + l``.
    """

    names: Tuple[str, ...]  # member function names (fn_id order)
    n_intervals: Tuple[int, ...]  # sub-interval count per member
    degrees: Tuple[int, ...]  # interpolation degree per member
    entry_bits: Tuple[int, ...]  # 8 | 16 | 32 → which codes vector
    max_degree: int  # widest member degree (lane padding target)
    boundaries: torch.Tensor  # (sum n_f+1,) f32 flat rows
    inv_delta: torch.Tensor  # (sum n_f,) f32
    base: torch.Tensor  # (sum n_f,) f32 — GLOBAL index into the width-group codes
    seg_count: torch.Tensor  # (sum n_f,) f32
    zero: torch.Tensor  # (sum n_f * (max_degree+1),) f32 lane-padded
    ramp: torch.Tensor  # (sum n_f * (max_degree+1),) f32 lane-padded
    scale: torch.Tensor  # (sum n_f * (max_degree+1),) f32 lane-padded
    codes8: torch.Tensor  # (max(M8,1),) int8
    codes16: torch.Tensor  # (max(M16,1),) int16
    codes32: torch.Tensor  # (max(M32,1),) f32 — raw coefficients
    domains: Tuple[Tuple[float, float], ...]  # member [lo, hi) on the host
    # routed dispatch's per-member int32 operands on the pack's device, built
    # once with the pack: see routing_scalars()
    routing: Tuple[torch.Tensor, ...]
    # the whole pack (routing operands, metadata lanes, code groups) as ONE
    # int32 buffer on the pack's device, built once with the pack: what a
    # block of the routed and of the static kernels stages where it fits
    # (poly_image_layout)
    image: torch.Tensor
    _extr_operands: Dict[bytes, torch.Tensor] = field(
        default_factory=dict, compare=False, repr=False)

    @property
    def max_lanes(self) -> int:
        return self.max_degree + 1

    def routing_scalars(self) -> Tuple[torch.Tensor, ...]:
        """The routed kernels' per-member operands, gathered by fn_id on the
        device: the quantized pack's tuple plus each member's coefficient
        stride ``degree + 1``: ``(n_arr, bounds_offsets, lane_offsets,
        entry_bits, strides)``, int32 vectors on the pack's device."""
        return self.routing

    def _groups(self):
        return {8: self.codes8, 16: self.codes16, 32: self.codes32}


def from_poly_layout(layout: PolyPackLayout,
                     device: DeviceLike = None) -> PolyTablePack:
    _check_exact(layout.codes8, layout.codes16, layout.codes32)
    dev = resolve_device(device)
    f32 = lambda a: f32_tensor(a, dev)
    routing = (layout.n_intervals, layout.bounds_offsets, layout.lane_offsets,
               layout.entry_bits, [d + 1 for d in layout.degrees])
    codes = (_codes_array(layout.codes8, torch.int8),
             _codes_array(layout.codes16, torch.int16),
             _codes_array(layout.codes32, torch.float32))
    return PolyTablePack(
        names=layout.names,
        n_intervals=layout.n_intervals,
        degrees=layout.degrees,
        entry_bits=layout.entry_bits,
        max_degree=layout.max_degree,
        boundaries=f32(layout.boundaries),
        inv_delta=f32(layout.inv_delta),
        base=f32(layout.base),
        seg_count=f32(layout.seg_count),
        zero=f32(layout.zero),
        ramp=f32(layout.ramp),
        scale=f32(layout.scale),
        codes8=torch.from_numpy(codes[0]).to(dev),
        codes16=torch.from_numpy(codes[1]).to(dev),
        codes32=torch.from_numpy(codes[2]).to(dev),
        domains=_domains(layout),
        routing=tuple(_int32_tensor(v, dev) for v in routing),
        image=_pack_image(
            layout, POLY_IMAGE_SECTIONS,
            *poly_image_layout(len(layout.names), len(layout.inv_delta),
                               layout.max_degree + 1, *(len(c) for c in codes)),
            routing, codes[::-1], dev),
    )


def build_poly_pack(
    names: Sequence[str],
    e_a: float,
    *,
    budget_bytes: Optional[int] = None,
    rho: float = 0.9,
    dtype: str = "auto",
    algorithm: str = "hierarchical",
    omega: float = 0.3,
    intervals: Optional[dict] = None,
    device: DeviceLike = None,
) -> PolyTablePack:
    """Planner-driven pack: :func:`repro_torch.core.design.plan` picks one
    (degree, dtype) candidate per function — cheapest when
    ``budget_bytes=None``, preferred-then-downgraded to fit a byte budget
    otherwise (an infeasible budget raises ``ValueError``) — and the chosen
    members fuse into one device artifact.  ``dtype`` narrows the planner's
    menu ('auto' keeps f32/int16/int8 all open); ``rho`` splits e_a between
    interpolation and code rounding for the integer candidates."""
    from repro_torch.core import design

    dtypes = design.POLY_DTYPES if dtype == "auto" else (dtype,)
    p = design.plan(list(names), e_a, budget_bytes, dtypes=dtypes,
                    algorithm=algorithm, omega=omega, rho=rho,
                    intervals=intervals)
    return from_poly_layout(poly_pack_layout(list(p.members)), device)


def _poly_select(pack: PolyTablePack, fid: int, xf: torch.Tensor):
    """Selector + four gathers against member ``fid``'s ragged lane segment,
    plus the dequant planes' (zero, ramp, scale) of each of its lanes."""
    j, p, (invd, base, segs) = _ragged_select(
        pack, fid, xf, (pack.inv_delta, pack.base, pack.seg_count))
    lmax = pack.max_lanes
    m0 = pack.lane_offset(fid) * lmax
    meta = [[plane[m0 + j * lmax + lane] for plane in (pack.zero, pack.ramp,
                                                       pack.scale)]
            for lane in range(pack.degrees[fid] + 1)]
    return p, invd, base, segs, meta


def _poly_coeffs(pack: PolyTablePack, fid: int, base, i, meta):
    """Gather + dequantize the cell's ``degree + 1`` monomial coefficients.

    Code of cell ``i``, lane ``l`` lives at ``base + i*(degree+1) + l`` in the
    member's width group; the dequant ``(zero + ramp*i) + scale*q`` is the
    quant-pack sequence per lane (identity for f32 members).
    """
    codes = pack.codes_for(fid)
    stride = float(pack.degrees[fid] + 1)
    cs = []
    for lane, (zero, ramp, scale) in enumerate(meta):
        a = lane_address(base + i * stride + float(lane), codes.shape[0])
        q = codes[a].to(torch.float32)
        cs.append((zero + ramp * i) + scale * q)
    return cs


def poly_horner(cs, t):
    """p(t) with monomial coefficients ``cs[k]`` (constant term first)."""
    y = cs[-1]
    for c in reversed(cs[:-1]):
        y = y * t + c
    return y


def poly_horner_d1(cs, t):
    """p'(t) in the derivative Horner form the kernels mirror."""
    if len(cs) == 1:
        return torch.zeros_like(t)
    g = cs[-1] * float(len(cs) - 1)
    for k in range(len(cs) - 2, 0, -1):
        g = g * t + cs[k] * float(k)
    return g


def _poly_cell(pack: PolyTablePack, fid: int, xf: torch.Tensor):
    """(coefficients, t, tc = clip(t, 0, 1), invd) of each element's cell."""
    p, invd, base, segs, meta = _poly_select(pack, fid, xf)
    u = (xf - p) * invd
    i = clamp_cell(u, segs)
    cs = _poly_coeffs(pack, fid, base, i, meta)
    t = u - i
    return cs, t, torch.clamp(t, 0.0, 1.0), invd


def eval_poly_pack_ref(pack: PolyTablePack, fn, x: torch.Tensor, *,
                       extrapolate: bool = False) -> torch.Tensor:
    """Plain PyTorch dequantize + Horner lookup — bit-identical to the JAX
    package's eager ``eval_poly_pack_ref`` and to the CUDA kernel.
    ``extrapolate=True`` continues past the cell grid along the tangent at the
    clamped coordinate: ``y = p(tc) + p'(tc) * (t - tc)``."""
    fid = pack.member_id(fn)
    dtype = x.dtype
    cs, t, tc, _ = _poly_cell(pack, fid, x.to(torch.float32))
    y = poly_horner(cs, tc)
    if extrapolate:
        y = y + poly_horner_d1(cs, tc) * (t - tc)
    return y.to(dtype)


def eval_poly_pack_slope(pack: PolyTablePack, fn, x: torch.Tensor, *,
                         extrapolate: bool = False) -> torch.Tensor:
    """d/dx of the polynomial surrogate: ``p'(tc) / delta`` (the tangent the
    extrapolating value path continues along), masked outside the domain when
    not extrapolating."""
    fid = pack.member_id(fn)
    dtype = x.dtype
    xf = x.to(torch.float32)
    cs, _, tc, invd = _poly_cell(pack, fid, xf)
    slope = poly_horner_d1(cs, tc) * invd
    if not extrapolate:
        slope = slope * _inside(pack, fid, xf)
    return slope.to(dtype)


def make_poly_pack_fn(pack: PolyTablePack, name: str, *,
                      use_kernel: bool = True, exact_d1=None,
                      extrapolate: bool = False):
    """Differentiable unary ``f(x)`` served from the polynomial pack.

    Mirrors :func:`make_quant_pack_fn`: ``use_kernel=True`` (``poly_pack``)
    runs ``poly_pack_lookup`` / the fused ``poly_pack_grad``, ``False``
    (``poly_pack_ref``) the plain versions.  Tangent: the Horner slope, or
    ``exact_d1(x)`` when given.
    """
    from repro_torch.kernels import table_pack_lookup as K

    fns = ((K.poly_pack_lookup, K.poly_pack_grad) if use_kernel
           else (K.poly_pack_lookup_plain, K.poly_pack_grad_plain))
    return _make_fn(pack, name, *fns, exact_d1, extrapolate)


# --------------------------------------------------------------------------------------
# ShardedPack — the f32 pack's values vector cut into per-shard slices.
# --------------------------------------------------------------------------------------
#
# The packs above are replicated: one values vector.  The sharded pack
# partitions it at sub-interval granularity (core.packing.shard_pack_layout);
# each shard answers ONLY the elements whose selected sub-interval it owns:
# it runs the whole (replicated, small) comparator plane, gathers from its
# LOCAL slice at the rebased address and masks unowned elements to zero.
# The contributions are summed in shard order, off the mesh on one device (the
# reference's stacked-shard-axis path).  Exactly one shard owns any selected
# sub-interval, so the sum adds one real value and S-1 zeros: the result
# equals the replicated pack's (an owner's -0.0 comes out +0.0 when S > 1).


@dataclass(frozen=True)
class ShardedTablePack:
    """Device-ready sharded multi-function pack (the reference's
    ``ShardedTablePack``; all planes f32 on one device, contiguous).

    ``values`` holds one PADDED slice per shard; ``local_base`` / ``owned``
    are the per-shard planes (rebased addresses, ownership mask); the
    selector metadata stays replicated.  ``owner`` / ``owner_base`` hold the
    same in one plane each, as the layout has them (the shard that owns each
    sub-interval and its base rebased into that shard's slice): what the
    card's kernels read.  See
    :class:`repro_torch.core.packing.ShardedPackLayout`.
    """

    names: Tuple[str, ...]  # member function names (fn_id order)
    n_intervals: Tuple[int, ...]  # real sub-interval count per member
    n_shards: int
    boundaries: torch.Tensor  # (F, n_max+1) f32, right-padded +inf  [replicated]
    inv_delta: torch.Tensor  # (F, n_max)   f32                      [replicated]
    seg_count: torch.Tensor  # (F, n_max)   f32                      [replicated]
    local_base: torch.Tensor  # (S, F, n_max) f32 — SHARD-LOCAL values index
    owned: torch.Tensor  # (S, F, n_max) f32 — 1.0 where shard s owns (f, j)
    values: torch.Tensor  # (S, m_max)   f32 — per-shard padded slices
    owner: torch.Tensor  # (F, n_max) f32 — the shard owning (f, j), -1 on padding
    owner_base: torch.Tensor  # (F, n_max) f32 — local_base of that shard (0 on padding)
    domains: Tuple[Tuple[float, float], ...]  # member domains [lo, hi), host
    # routed dispatch's per-member int32 operands, built once with the pack
    routing: Tuple[torch.Tensor, ...]
    # the staging image of the whole pack (sharded_image_layout) and where
    # its values slices start, built once with the pack: what a block of the
    # static and routed grad kernels stages where it fits
    image: Optional[Tuple[torch.Tensor, int]]
    _extr_operands: Dict[bytes, torch.Tensor] = field(
        default_factory=dict, compare=False, repr=False)
    # placed on a mesh (repro_torch.parallel.sharding.place_sharded_pack):
    # the DeviceMesh, and the shard of ``values[0]``.  A placed pack holds
    # ONE slice (``values`` (1, m), ``local_base`` / ``owned`` (1, F, n)),
    # its ``owner`` plane says 0 where that slice owns a sub-interval and -1
    # elsewhere, and it keeps no staging ``image``.
    mesh: Any = field(default=None, compare=False, repr=False)
    first_shard: int = 0

    @property
    def n_functions(self) -> int:
        return len(self.names)

    @property
    def n_max(self) -> int:
        return self.inv_delta.shape[1]

    @property
    def footprint_per_shard(self) -> int:
        """Padded per-shard entry count (every shard's slice has it)."""
        return self.values.shape[1]

    @property
    def n_local(self) -> int:
        """How many shards' slices this pack holds (``n_shards`` unless
        placed on a mesh, then 1)."""
        return self.values.shape[0]

    def local_shard(self, shard: int) -> int:
        """Index into the held slices of global shard ``shard``."""
        s = shard - self.first_shard
        if not 0 <= s < self.n_local:
            held = (f"shard {self.first_shard}" if self.mesh is not None
                    else f"{self.n_shards} shards")
            raise IndexError(f"shard {shard} is not held here (the pack holds {held})")
        return s

    def check_whole(self) -> None:
        """Raise unless this pack holds every shard (an off-mesh sum)."""
        if self.n_local != self.n_shards:
            raise ValueError(
                "this sharded pack is placed on a mesh and holds one slice: "
                "evaluate it with eval_sharded_mesh (its closure does)")

    @property
    def device(self) -> torch.device:
        return self.values.device

    def fn_id(self, name: str) -> int:
        return _member_id(self.names, name)

    def member_id(self, fn) -> int:
        """Name or integer fn_id -> validated index (KeyError otherwise)."""
        return _member_id(self.names, fn)

    def routing_scalars(self) -> Tuple[torch.Tensor, ...]:
        """``(n_arr,)``, as :meth:`TablePack.routing_scalars`."""
        return self.routing


def _sharded_image(slayout: ShardedPackLayout, values: np.ndarray,
                   dev: torch.device) -> Tuple[torch.Tensor, int]:
    """The staging image of a sharded pack (sharded_image_layout), from the
    numbers its planes hold (the header's counts are exact in f32), and
    where its values slices start."""
    lay = slayout.layout
    f32 = lambda a: np.asarray(a, np.float64).astype(np.float32)
    starts, v_at, words = sharded_image_layout(lay.n_intervals, slayout.n_shards,
                                               values.shape[1])
    img = np.zeros(words, np.float32)
    for f, (at, n) in enumerate(zip(starts, lay.n_intervals)):
        img[2 * f: 2 * f + 2] = (at, n)
        img[at: at + 4 * n] = np.stack(
            [f32(lay.inv_delta[f, :n]), f32(slayout.local_base[f, :n]),
             f32(lay.seg_count[f, :n]), f32(slayout.owner[f, :n])], axis=1).reshape(-1)
        img[at + 4 * n: at + 5 * n + 1] = f32(lay.boundaries[f, : n + 1])
    img[v_at: v_at + values.size] = f32(values).reshape(-1)
    return torch.from_numpy(img).to(dev), v_at


def from_sharded_layout(slayout: ShardedPackLayout,
                        device: DeviceLike = None) -> ShardedTablePack:
    if slayout.max_shard_entries >= EXACT_INT_LIMIT:
        raise ValueError("shard slice exceeds f32 exact-integer range")
    lay = slayout.layout
    S, m_max = slayout.n_shards, slayout.max_shard_entries
    dev = resolve_device(device)
    vals = np.zeros((S, m_max), dtype=np.float64)
    lb = np.zeros((S,) + slayout.owner.shape, dtype=np.float64)
    own = np.zeros((S,) + slayout.owner.shape, dtype=np.float64)
    for s in range(S):
        sv = slayout.shard_values(s)
        vals[s, : len(sv)] = sv
        mask = slayout.owner == s
        lb[s][mask] = slayout.local_base[mask]
        own[s][mask] = 1.0
    return ShardedTablePack(
        names=lay.names,
        n_intervals=lay.n_intervals,
        n_shards=S,
        boundaries=f32_tensor(lay.boundaries, dev),
        inv_delta=f32_tensor(lay.inv_delta, dev),
        seg_count=f32_tensor(lay.seg_count, dev),
        local_base=f32_tensor(lb, dev),
        owned=f32_tensor(own, dev),
        values=f32_tensor(vals, dev),
        owner=f32_tensor(slayout.owner, dev),
        owner_base=f32_tensor(slayout.local_base, dev),
        domains=_row_domains(lay),
        routing=(_int32_tensor(lay.n_intervals, dev),),
        image=_sharded_image(slayout, vals, dev),
    )


def shard_pack(pack_or_specs, n_shards: int,
               device: DeviceLike = None) -> ShardedTablePack:
    """Shard already-built TableSpecs (or a PackLayout) into a device pack."""
    layout = (pack_or_specs if isinstance(pack_or_specs, PackLayout)
              else pack_layout(list(pack_or_specs)))
    return from_sharded_layout(shard_pack_layout(layout, n_shards), device)


def build_sharded_pack(
    names: Sequence[str],
    e_a: float,
    n_shards: int,
    *,
    algorithm: str = "hierarchical",
    omega: float = 0.3,
    intervals: Optional[dict] = None,
    device: DeviceLike = None,
) -> ShardedTablePack:
    """Design flow for every name, fused into one pack, sharded ``n_shards``
    ways."""
    intervals = intervals or {}
    specs = []
    for name in names:
        lo, hi = intervals.get(name, (None, None))
        specs.append(cached_table(name, e_a, lo, hi, algorithm=algorithm,
                                  omega=omega))
    return shard_pack(specs, n_shards, device)


def shard_contrib_ref(values_s, lbase_row, own_row, brow, invd_row, segs_row,
                      n: int, xf: torch.Tensor, *, extrapolate: bool,
                      slope: bool = False) -> torch.Tensor:
    """ONE shard's masked contribution (f32) — the sharded-lookup contract.

    The replicated comparator plane, the gathers at the selected
    sub-interval j (with the shard's rebased base and its ownership flag),
    the pair gather from the LOCAL slice (clamped like ``mode="clip"``:
    unowned elements may address past it), the lerp or the slope, and a
    SELECT of the owned elements: an unowned NaN or inf becomes 0, as
    ``jnp.where`` makes it.  The owner runs the replicated pack's op
    sequence on the same f32 numbers, so the S contributions sum to
    ``eval_pack_ref`` / ``eval_pack_slope``.
    """
    j = select_interval(brow, n, xf)
    p, invd, base, segs, own = (brow[j], invd_row[j], lbase_row[j],
                                segs_row[j], own_row[j])
    u = (xf - p) * invd
    i = clamp_cell(u, segs)
    a0, a1 = pair_address(base, i, values_s.shape[0])
    y0, y1 = values_s[a0], values_s[a1]
    if slope:
        out = (y1 - y0) * invd
        if not extrapolate:
            inside = (xf >= brow[0]) & (xf < brow[n])
            out = out * inside.to(torch.float32)
    else:
        t = u - i
        if not extrapolate:
            t = torch.clamp(t, 0.0, 1.0)
        out = y0 + t * (y1 - y0)
    return torch.where(own > 0, out, 0.0)


def shard_contrib(pack: ShardedTablePack, fid: int, s: int, xf: torch.Tensor, *,
                  extrapolate: bool, slope: bool = False) -> torch.Tensor:
    """Shard ``s``'s contribution of member ``fid`` (f32); a placed pack
    answers for its own shard only."""
    s = pack.local_shard(s)
    return shard_contrib_ref(
        pack.values[s], pack.local_base[s, fid], pack.owned[s, fid],
        pack.boundaries[fid], pack.inv_delta[fid], pack.seg_count[fid],
        pack.n_intervals[fid], xf, extrapolate=extrapolate, slope=slope)


def _sharded_sum_ref(pack: ShardedTablePack, fn, x: torch.Tensor,
                     extrapolate: bool, slope: bool) -> torch.Tensor:
    pack.check_whole()
    fid = pack.member_id(fn)
    xf = x.to(torch.float32)
    out = None
    for s in range(pack.n_shards):
        c = shard_contrib(pack, fid, s, xf, extrapolate=extrapolate, slope=slope)
        out = c if out is None else out + c
    return out.to(x.dtype)


def eval_sharded_ref(pack: ShardedTablePack, fn, x: torch.Tensor, *,
                     extrapolate: bool = False) -> torch.Tensor:
    """Plain sharded lookup (the shards' f32 contributions summed in shard
    order, then cast): bitwise the reference's eager ``eval_sharded_ref``,
    and equal to the replicated ``eval_pack_ref``."""
    return _sharded_sum_ref(pack, fn, x, extrapolate, slope=False)


def eval_sharded_slope(pack: ShardedTablePack, fn, x: torch.Tensor, *,
                       extrapolate: bool = False) -> torch.Tensor:
    """d/dx of the sharded surrogate, summed like :func:`eval_sharded_ref`."""
    return _sharded_sum_ref(pack, fn, x, extrapolate, slope=True)


def _active_pack_mesh(pack: ShardedTablePack):
    """The mesh the pack evaluates on, or None for the off-mesh sum: a
    placed pack's own mesh always (the rank holds one slice), else the
    mesh that ``use_sharding`` binds IF its 'model' axis is ``n_shards``
    wide (each rank then answers for the shard at its 'model' coordinate
    from the whole pack it holds)."""
    if pack.mesh is not None:
        return pack.mesh
    mesh = current_mesh()
    if mesh is not None and axis_sizes(mesh).get("model") == pack.n_shards:
        return mesh
    return None


def eval_sharded_mesh(pack: ShardedTablePack, fn, x: torch.Tensor, mesh, *,
                      extrapolate: bool = False, use_kernel: bool = False,
                      slope: bool = False) -> torch.Tensor:
    """Sharded evaluation distributed over ``mesh``'s 'model' axis (the
    reference's shard_map body + psum).

    x is cast to f32 and, as a DTensor, gathered to replicated (the
    reference's replicated ``in_specs``); a plain tensor is taken as the
    same on every rank of the 'model' group.  The rank takes its shard's
    masked contribution (``sharded_shard_contrib``: one launch of
    ``tp_spack_lookup`` over its one slice, the value or with ``slope`` the
    segment slope; ``sharded_shard_contrib_plain`` with ``use_kernel``
    False), the f32 contributions are all-reduced (SUM) over the 'model'
    group and the sum is cast to x's dtype; a DTensor comes back with x's
    placements.  The sum adds one owner value and S-1 zeros, so the result
    is bitwise the off-mesh ``eval_sharded_ref`` / ``eval_sharded_slope``
    and the replicated pack's (an owner's -0.0 comes out +0.0 when S > 1).
    """
    import torch.distributed as dist
    from repro_torch.kernels import table_pack_lookup as K
    from repro_torch.parallel.sharding import is_dtensor, local_rank

    fid = pack.member_id(fn)
    dtype = x.dtype
    xf = x.to(torch.float32)
    placements = None
    if is_dtensor(xf):
        placements = xf.placements
        xf = xf.full_tensor()
    contrib = K.sharded_shard_contrib if use_kernel else K.sharded_shard_contrib_plain
    c = contrib(pack, fid, local_rank(mesh, "model"), xf,
                extrapolate=extrapolate, slope=slope)
    dist.all_reduce(c, op=dist.ReduceOp.SUM, group=mesh.get_group("model"))
    out = c.to(dtype)
    if placements is None:
        return out
    from torch.distributed.tensor import DTensor, Replicate

    full = DTensor.from_local(out, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return full.redistribute(mesh, placements)  # this rank's chunk: no traffic


def make_sharded_pack_fn(pack: ShardedTablePack, name: str, *,
                         use_kernel: bool = True, exact_d1=None,
                         extrapolate: bool = False):
    """Differentiable unary ``f(x)`` served from the SHARDED pack.

    The execution is picked at each call: on the pack's mesh
    (:func:`_active_pack_mesh`: always for a placed pack, whether or not
    ``use_sharding`` is bound, since the rank lacks the other slices) by
    :func:`eval_sharded_mesh`, the value and under a gradient the slope as
    two mesh evaluations (the reference's jvp); off it on one device, where
    ``use_kernel=True`` (``sharded_pack``) runs ``sharded_pack_lookup``
    without a gradient and the fused value + slope ``sharded_pack_grad``
    under one (each one launch a call over the S shards), ``False``
    (``sharded_pack_ref``) the plain versions, over a DTensor's local
    shards.  Tangent: the table slope, or ``exact_d1(x)`` when given.
    """
    from repro_torch.kernels import table_pack_lookup as K
    from repro_torch.parallel.sharding import elementwise

    fns = ((K.sharded_pack_lookup, K.sharded_pack_grad) if use_kernel
           else (K.sharded_pack_lookup_plain, K.sharded_pack_grad_plain))
    off = _make_fn(pack, name, *fns, exact_d1, extrapolate)
    fid = pack.fn_id(name)

    def f(x):
        mesh = _active_pack_mesh(pack)
        if mesh is None:
            return elementwise(off, x)
        value = lambda v, s=False: eval_sharded_mesh(
            pack, fid, v, mesh, extrapolate=extrapolate, use_kernel=use_kernel, slope=s)
        if exact_d1 is not None:
            fused = lambda v: (value(v), exact_d1(v))
        else:
            fused = lambda v: (value(v), value(v, True))
        return slope_rule(value, fused)(x)

    f.takes_dtensor = True  # gathers a DTensor itself (see parallel.sharding)
    return f


# --------------------------------------------------------------------------------------
# Routed dispatch — per-row fn_id as a RUNTIME operand (mixed-function batches).
# --------------------------------------------------------------------------------------
#
# The static closures above bake the member into the launch.  The routed path
# takes a per-row ``fn_ids`` vector instead: the kernels of
# :mod:`repro_torch.kernels.routed_pack_lookup` read it on the device, so
# one compiled kernel serves every routing and a new routing is a new operand,
# never a host read.  The oracles define the contract: row i of the output is
# bit-identical to the static dispatch of member ``fn_ids[i]`` (the
# where-select picks the static per-member evaluations).


def _fn_id_operand(pack, fn_ids, rows: int) -> torch.Tensor:
    """``(rows,)`` int32 ids on the pack's device, as the routed kernels take
    them.  A name or int is broadcast to every row and a sequence or numpy
    array is validated id by id (``KeyError`` listing the members); a
    ``torch.Tensor`` (a router's output) is taken as it is, never read on the
    host: the kernels clamp it to ``[0, F-1]`` themselves."""
    if isinstance(fn_ids, torch.Tensor):
        if fn_ids.device != pack.device:
            raise ValueError(f"fn_ids live on {fn_ids.device}, the pack on "
                             f"{pack.device}")
        ids = fn_ids.to(torch.int32)
    elif isinstance(fn_ids, (str, int, np.integer)):
        ids = torch.full((rows,), pack.member_id(fn_ids), dtype=torch.int32,
                         device=pack.device)
    else:  # a concrete sequence or array of names or ints: validate every id
        seq = fn_ids if isinstance(fn_ids, (list, tuple)) else np.asarray(fn_ids)
        ids = torch.tensor([pack.member_id(f) for f in seq], dtype=torch.int32,
                           device=pack.device)
    if tuple(ids.shape) != (rows,):
        raise ValueError(
            f"fn_ids shape {tuple(ids.shape)} does not match the {rows} leading "
            f"rows of x (one function id per row)")
    return ids


def resolve_fn_ids(pack, fn_ids, rows: int) -> torch.Tensor:
    """Normalize per-row routing ids to a clamped ``(rows,)`` int32 vector on
    the pack's device.

    Accepts a single name/int (broadcast to every row), a sequence of
    names/ints or a numpy array (each validated against the pack —
    ``KeyError`` on unknowns), or a ``torch.Tensor`` of ids (e.g. a router
    output on the card), which is clamped to the member range with
    ``torch.clamp`` and never read on the host, matching the kernels' clamped
    metadata reads (the reference's traced-id case).
    """
    ids = _fn_id_operand(pack, fn_ids, rows)
    if isinstance(fn_ids, torch.Tensor):
        ids = torch.clamp(ids, 0, pack.n_functions - 1)
    return ids


def routed_extr_flags(pack, extrapolate) -> np.ndarray:
    """Per-member edge-handling flags as int32 (the operand the routed kernels
    gather by fn_id): a single bool applies to every member, a sequence gives
    one flag per member (linear-asymptote members extrapolate, flat ones keep
    the hardware clamp)."""
    if isinstance(extrapolate, (bool, np.bool_, int)):
        flags = (bool(extrapolate),) * pack.n_functions
    else:
        flags = tuple(bool(e) for e in extrapolate)
        if len(flags) != pack.n_functions:
            raise ValueError(
                f"extrapolate needs one flag per member ({pack.n_functions}), "
                f"got {len(flags)}")
    return np.asarray(flags, dtype=np.int32)


def routed_extr_operand(pack, extrapolate) -> torch.Tensor:
    """:func:`routed_extr_flags` as an int32 vector on the pack's device,
    built once per pack and flag tuple (a later call with the same flags
    makes no host-to-device copy)."""
    flags = routed_extr_flags(pack, extrapolate)
    key = flags.tobytes()
    if key not in pack._extr_operands:
        pack._extr_operands[key] = torch.from_numpy(flags).to(pack.device)
    return pack._extr_operands[key]


def _routed_where(pack, fn_ids, x: torch.Tensor, member_eval, extrapolate):
    """Row-select over the static per-member evaluations (the routed oracle)."""
    if x.dim() < 1:
        raise ValueError("routed dispatch needs a leading row axis (one "
                         "function id per row); got a 0-d input")
    ids = resolve_fn_ids(pack, fn_ids, x.shape[0])
    extr = routed_extr_flags(pack, extrapolate)
    ids = ids.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    y = None
    for f in range(pack.n_functions):
        yf = member_eval(f, bool(extr[f]))
        y = yf if y is None else torch.where(ids == f, yf, y)
    return y


def eval_routed_ref(pack: TablePack, fn_ids, x: torch.Tensor, *,
                    extrapolate=False) -> torch.Tensor:
    """Plain routed lookup: row i of ``x`` through member ``fn_ids[i]`` —
    bit-identical to the static dispatches and to the reference's eager
    ``eval_routed_ref``."""
    return _routed_where(
        pack, fn_ids, x,
        lambda f, e: eval_pack_ref(pack, f, x, extrapolate=e), extrapolate)


def eval_routed_slope(pack: TablePack, fn_ids, x: torch.Tensor, *,
                      extrapolate=False) -> torch.Tensor:
    """d/dx of the routed surrogate (per-row static table slopes)."""
    return _routed_where(
        pack, fn_ids, x,
        lambda f, e: eval_pack_slope(pack, f, x, extrapolate=e), extrapolate)


def eval_routed_quant_ref(pack: QuantTablePack, fn_ids, x: torch.Tensor, *,
                          extrapolate=False) -> torch.Tensor:
    """Plain routed dequantize-on-read lookup over the quantized pack."""
    return _routed_where(
        pack, fn_ids, x,
        lambda f, e: eval_quant_pack_ref(pack, f, x, extrapolate=e), extrapolate)


def eval_routed_quant_slope(pack: QuantTablePack, fn_ids, x: torch.Tensor, *,
                            extrapolate=False) -> torch.Tensor:
    """d/dx of the routed quantized surrogate."""
    return _routed_where(
        pack, fn_ids, x,
        lambda f, e: eval_quant_pack_slope(pack, f, x, extrapolate=e),
        extrapolate)


def eval_routed_poly_ref(pack: PolyTablePack, fn_ids, x: torch.Tensor, *,
                         extrapolate=False) -> torch.Tensor:
    """Plain routed dequantize + Horner lookup over the polynomial pack."""
    return _routed_where(
        pack, fn_ids, x,
        lambda f, e: eval_poly_pack_ref(pack, f, x, extrapolate=e), extrapolate)


def eval_routed_poly_slope(pack: PolyTablePack, fn_ids, x: torch.Tensor, *,
                           extrapolate=False) -> torch.Tensor:
    """d/dx of the routed polynomial surrogate."""
    return _routed_where(
        pack, fn_ids, x,
        lambda f, e: eval_poly_pack_slope(pack, f, x, extrapolate=e),
        extrapolate)


def eval_routed_sharded_ref(pack: ShardedTablePack, fn_ids, x: torch.Tensor, *,
                            extrapolate=False) -> torch.Tensor:
    """Plain routed lookup over the SHARDED pack: row i through member
    ``fn_ids[i]``, each member's value summed from its shard contributions."""
    return _routed_where(
        pack, fn_ids, x,
        lambda f, e: eval_sharded_ref(pack, f, x, extrapolate=e), extrapolate)


def eval_routed_sharded_slope(pack: ShardedTablePack, fn_ids, x: torch.Tensor, *,
                              extrapolate=False) -> torch.Tensor:
    """d/dx of the routed sharded surrogate."""
    return _routed_where(
        pack, fn_ids, x,
        lambda f, e: eval_sharded_slope(pack, f, x, extrapolate=e), extrapolate)


def _routed_family(pack) -> str:
    """``"f32"``, ``"quant"``, ``"poly"`` or ``"sharded"``: the pack family
    the routed kernels serve."""
    for cls, family in ((PolyTablePack, "poly"), (QuantTablePack, "quant"),
                        (TablePack, "f32"), (ShardedTablePack, "sharded")):
        if isinstance(pack, cls):
            return family
    raise TypeError(f"routed dispatch serves a TablePack, QuantTablePack, "
                    f"PolyTablePack or ShardedTablePack, not a "
                    f"{type(pack).__name__}")


def _routed_kernels(family: str, use_kernel: bool):
    """(value, value + slope) routed wrappers of a pack family: the kernels
    or, with ``use_kernel=False``, their plain versions."""
    from repro_torch.kernels import routed_pack_lookup as R

    name = {"f32": "routed_pack", "quant": "routed_quant_pack",
            "poly": "routed_poly_pack", "sharded": "sharded_routed_pack"}[family]
    suffix = "" if use_kernel else "_plain"
    return (getattr(R, f"{name}_lookup{suffix}"), getattr(R, f"{name}_grad{suffix}"))


def make_routed_fn(pack, fn_ids, *, use_kernel: bool = True, extrapolate=False):
    """Differentiable per-row routed ``f(x)``: row i of ``x`` (leading axis)
    is served by member ``fn_ids[i]`` of the pack — f32 (:class:`TablePack`),
    quantized (:class:`QuantTablePack`), polynomial (:class:`PolyTablePack`)
    or sharded (:class:`ShardedTablePack`: the value and the value + slope
    each one launch a call over the S shards).

    ``fn_ids`` may be names/ints (validated here and copied to the pack's
    device once) or a ``torch.Tensor`` of ids on the pack's device (a
    router's output, read only by the kernel).  ``extrapolate`` is one flag
    or a per-member sequence.  ``use_kernel=True`` runs the routed CUDA
    kernels (``routed_pack`` / ``routed_quant_pack`` / ``routed_poly_pack`` /
    ``sharded_pack``):
    the value kernel without a gradient, the fused value + slope kernel under
    one; ``use_kernel=False`` the plain versions.  Tangent: the per-row table
    slope.
    """
    lookup, grad = _routed_kernels(_routed_family(pack), use_kernel)
    if not isinstance(fn_ids, (str, int, np.integer, torch.Tensor)):
        fn_ids = resolve_fn_ids(pack, fn_ids, len(fn_ids))
    flags = tuple(bool(e) for e in routed_extr_flags(pack, extrapolate))
    routed_extr_operand(pack, flags)  # the device flag vector, built now
    return slope_rule(lambda v: lookup(pack, fn_ids, v, extrapolate=flags),
                      lambda v: grad(pack, fn_ids, v, extrapolate=flags))


def make_routed_unary_fn(pack, name, *, use_kernel: bool = True, exact_d1=None,
                         extrapolate: bool = False):
    """Shape-agnostic unary ``f(x)`` served through the ROUTED dispatch path
    with one id for the whole tensor — what ``ApproxConfig(mode=
    "routed_pack").unary`` (and its quantized and polynomial variants)
    builds.  The member is a runtime operand: x is viewed as one row, and its
    one-element id vector is built here, once, on the pack's device (no
    host-to-device copy per call).  ``use_kernel=False``
    (``routed_*_ref``) is the static plain version, bit-identical to the
    routed kernel by the dispatch contract.  Tangent: the table slope, or
    ``exact_d1(x)`` when given.
    """
    from repro_torch.kernels import table_pack_lookup as K

    family = _routed_family(pack)
    fid = pack.member_id(name)
    if use_kernel:
        lookup, grad = _routed_kernels(family, True)
        ids = torch.full((1,), fid, dtype=torch.int32, device=pack.device)
        routed_extr_operand(pack, extrapolate)
        value = lambda v: lookup(pack, ids, v.reshape(1, -1),
                                 extrapolate=extrapolate).reshape(v.shape)
        fused = lambda v: tuple(r.reshape(v.shape) for r in grad(
            pack, ids, v.reshape(1, -1), extrapolate=extrapolate))
    else:
        static, static_grad = {
            "f32": (K.table_pack_lookup_plain, K.table_pack_grad_plain),
            "quant": (K.quant_pack_lookup_plain, K.quant_pack_grad_plain),
            "poly": (K.poly_pack_lookup_plain, K.poly_pack_grad_plain),
            "sharded": (K.sharded_pack_lookup_plain,
                        K.sharded_pack_grad_plain)}[family]
        value = lambda v: static(pack, fid, v, extrapolate=extrapolate)
        fused = lambda v: static_grad(pack, fid, v, extrapolate=extrapolate)
    if exact_d1 is not None:
        fused = lambda v: (value(v), exact_d1(v))
    return slope_rule(value, fused)
