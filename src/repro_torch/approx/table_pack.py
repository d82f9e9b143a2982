"""TablePack — every table a model needs, fused into ONE device artifact (the
f32 part of the JAX package's ``approx/table_pack.py``).

The paper keeps each function's table resident in BRAM next to its consumer
(Sec. 7.2); a network evaluates a *set* of nonlinearities, so a
:class:`TablePack` concatenates all range values into a single ``values``
vector and stores the selector metadata as (F, n_max) padded planes (see
:class:`repro_torch.core.packing.PackLayout`).  ONE artifact stays on the
device for the whole network, and ONE kernel — :mod:`repro_torch.kernels.
table_pack_lookup` — serves any member through its ``fn_id`` row.

``eval_pack_ref`` is the plain PyTorch lookup: bit-identical to the JAX
package's eager ``eval_pack_ref`` and to the CUDA kernel.

``make_pack_fn`` and ``make_attn_exp_fn`` are differentiable through
:func:`~repro_torch.approx.torch_table.slope_rule`: under a gradient the
forward runs the fused value + slope kernel (``table_pack_grad``) and the
backward multiplies the saved slope into the incoming gradient.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.flow import cached_table
from repro_torch.core.packing import PackLayout, pack_layout
from repro_torch.core.table import TableSpec
from repro_torch.device import DeviceLike, resolve_device

from .torch_table import (EXACT_INT_LIMIT, f32_tensor, lookup_rows, slope_rows,
                          slope_rule)


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


def from_layout(layout: PackLayout, device: DeviceLike = None) -> TablePack:
    if layout.footprint >= EXACT_INT_LIMIT:
        raise ValueError("pack footprint exceeds f32 exact-integer range")
    dev = resolve_device(device)
    boundaries = f32_tensor(layout.boundaries, dev)
    host_b = boundaries.cpu()
    domains = tuple((float(host_b[f, 0]), float(host_b[f, n]))
                    for f, n in enumerate(layout.n_intervals))
    return TablePack(
        names=layout.names,
        n_intervals=layout.n_intervals,
        boundaries=boundaries,
        inv_delta=f32_tensor(layout.inv_delta, dev),
        delta=f32_tensor(layout.delta, dev),
        base=f32_tensor(layout.base, dev),
        seg_count=f32_tensor(layout.seg_count, dev),
        values=f32_tensor(layout.values, dev),
        domains=domains,
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
    fid = pack.fn_id(name)
    if use_kernel:
        from repro_torch.kernels.table_pack_lookup import (table_pack_grad,
                                                           table_pack_lookup)

        value = lambda v: table_pack_lookup(pack, fid, v, extrapolate=extrapolate)
        fused = lambda v: table_pack_grad(pack, fid, v, extrapolate=extrapolate)
    else:
        value = lambda v: eval_pack_ref(pack, fid, v, extrapolate=extrapolate)
        fused = lambda v: (value(v), eval_pack_slope(pack, fid, v,
                                                     extrapolate=extrapolate))
    if exact_d1 is not None:
        fused = lambda v: (value(v), exact_d1(v))
    return slope_rule(value, fused)


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
