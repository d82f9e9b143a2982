"""Routed Hopper kernels: per-row fn_id dispatch over a
:class:`~repro_torch.approx.table_pack.TablePack`, a
:class:`~repro_torch.approx.table_pack.QuantTablePack` or a
:class:`~repro_torch.approx.table_pack.PolyTablePack`, with their wrappers
and plain PyTorch versions.

Row i of x (its leading axis; the trailing axes are the row's columns) goes
through member ``fn_ids[i]``.  The ids, and the per-member interval counts,
extrapolate flags and (quantized pack) ragged offsets and code widths, are
int32 vectors on the card that the kernel gathers by fn_id (the polynomial
pack adds each member's coefficient stride), so one compiled
kernel serves every routing and the wrappers never read the routing on the
host: a new routing is a new operand, and a routed call can be captured in a
CUDA graph whose ids tensor is rewritten in place between replays.

  * :func:`routed_pack_lookup` / :func:`routed_pack_grad` — the f32 pack,
    value or value + slope.  CUDA kernels ``tp_routed_lookup`` /
    ``tp_routed_grad`` in ``csrc/table_pack_lookup.cu``; replace the TPU
    kernels ``_routed_kernel`` / ``_routed_grad_kernel``
    (``src/repro/kernels/routed_pack_lookup.py:101``, ``:126``).  Plain
    versions: ``eval_routed_ref`` and ``eval_routed_slope``.
  * :func:`routed_quant_pack_lookup` / :func:`routed_quant_pack_grad` — the
    quantized pack.  CUDA kernels ``tp_routed_quant_lookup`` /
    ``tp_routed_quant_grad``; replace ``_routed_quant_kernel`` /
    ``_routed_quant_grad_kernel`` (``:300``, ``:329``).  Plain versions:
    ``eval_routed_quant_ref`` and ``eval_routed_quant_slope``.
  * :func:`routed_poly_pack_lookup` / :func:`routed_poly_pack_grad` — the
    polynomial pack (three code widths, degree-1..3 Horner cells).  CUDA
    kernels ``tp_routed_poly_lookup`` / ``tp_routed_poly_grad``; replace
    ``_routed_poly_kernel`` / ``_routed_poly_grad_kernel`` (``:641``,
    ``:670``).  Plain versions: ``eval_routed_poly_ref`` and
    ``eval_routed_poly_slope``.
  * :func:`sharded_routed_pack_lookup` / :func:`sharded_routed_pack_grad` —
    the sharded pack: each shard gathers from its values slice, elements the
    shard does not own masked to zero, the contributions summed in shard
    order in x's dtype: one launch a call over all S shards, summed on the
    card (the value + slope stages the pack's staging image,
    ``ShardedTablePack.image``, where it fits, and enters a row of another
    member by pointing at another row of it).  CUDA kernels
    ``tp_sharded_routed_lookup`` / ``tp_sharded_routed_grad``; replace
    ``_sharded_routed_kernel`` / ``_sharded_routed_grad_kernel`` and their
    sum, ``_sharded_routed_sum`` (``:451``, ``:480``, ``:529``).  Plain
    versions:
    ``eval_routed_sharded_ref`` and ``eval_routed_sharded_slope``.
    :func:`sharded_routed_shard_contrib` is one shard's routed contribution
    (the value kernel over a range of one shard).

``fn_ids`` is a name or int (every row), a sequence of names/ints (validated,
``KeyError`` on an unknown member) or a ``torch.Tensor`` of ids on the pack's
device (clamped to ``[0, F-1]``: by ``torch.clamp`` in the plain versions, by
the kernel on the card).  ``extrapolate`` is one flag or one per member.
Every wrapper goes through :func:`repro_torch.kernels._lib.run`: a CPU tensor
gets the plain version, a CUDA tensor one launch or an error.
"""

from __future__ import annotations

import torch

from repro_torch.approx.table_pack import (PolyTablePack, QuantTablePack,
                                          ShardedTablePack, TablePack,
                                          _fn_id_operand, _routed_where,
                                          eval_routed_poly_ref,
                                          eval_routed_poly_slope,
                                          eval_routed_quant_ref,
                                          eval_routed_quant_slope, eval_routed_ref,
                                          eval_routed_sharded_ref,
                                          eval_routed_sharded_slope,
                                          eval_routed_slope, routed_extr_operand,
                                          shard_contrib)

from ._lib import launches, reset_launches, run

__all__ = ["launches", "reset_launches", "routed_pack_lookup",
           "routed_pack_lookup_plain", "routed_pack_grad", "routed_pack_grad_plain",
           "routed_quant_pack_lookup", "routed_quant_pack_lookup_plain",
           "routed_quant_pack_grad", "routed_quant_pack_grad_plain",
           "routed_poly_pack_lookup", "routed_poly_pack_lookup_plain",
           "routed_poly_pack_grad", "routed_poly_pack_grad_plain",
           "sharded_routed_pack_lookup", "sharded_routed_pack_lookup_plain",
           "sharded_routed_pack_grad", "sharded_routed_pack_grad_plain",
           "sharded_routed_shard_contrib", "sharded_routed_shard_contrib_plain"]


def _rows(x: torch.Tensor) -> int:
    if x.dim() < 1:
        raise ValueError("routed dispatch needs a leading row axis (one "
                         "function id per row); got a 0-d input")
    return x.shape[0]


def _routed_args(pack: TablePack, fn_ids, x: torch.Tensor, extrapolate):
    """(planes, ints) of an f32-pack routed entry point: the routing
    operands and the members' row starts in the pack's staging image, the
    pack's planes and its staging image, the sizes, the sub-interval count
    and the values the image holds."""
    rows = _rows(x)
    (n_arr,) = pack.routing_scalars()
    image, m_img = pack.image
    return ((_fn_id_operand(pack, fn_ids, rows).contiguous(), n_arr, pack.image_rows,
             routed_extr_operand(pack, extrapolate), pack.boundaries,
             pack.inv_delta, pack.base, pack.seg_count, pack.values, image),
            (pack.n_functions, pack.n_max, pack.footprint, sum(pack.n_intervals),
             m_img, rows))


def _routed_quant_args(pack: QuantTablePack, fn_ids, x: torch.Tensor, extrapolate):
    """(planes, ints) of a quant-pack routed entry point: the routing
    operands, the pack's planes and code groups and its staging image, the
    sizes and the sub-interval count that lay the image out."""
    rows = _rows(x)
    n_arr, bo, lo, bits = pack.routing_scalars()
    return ((_fn_id_operand(pack, fn_ids, rows).contiguous(), n_arr,
             routed_extr_operand(pack, extrapolate), bo, lo, bits, pack.boundaries,
             pack.inv_delta, pack.base, pack.seg_count, pack.scale, pack.zero,
             pack.ramp, pack.codes8, pack.codes16, pack.image),
            (pack.n_functions, max(pack.n_intervals), pack.codes8.shape[0],
             pack.codes16.shape[0], pack.inv_delta.shape[0], rows))


def _routed_poly_args(pack: PolyTablePack, fn_ids, x: torch.Tensor, extrapolate):
    """(planes, ints) of a poly-pack routed entry point: the routing
    operands, the pack's planes and code groups and its staging image, the
    sizes and the sub-interval count that lay the image out."""
    rows = _rows(x)
    n_arr, bo, lo, bits, strides = pack.routing_scalars()
    return ((_fn_id_operand(pack, fn_ids, rows).contiguous(), n_arr,
             routed_extr_operand(pack, extrapolate), bo, lo, bits, strides,
             pack.boundaries, pack.inv_delta, pack.base, pack.seg_count, pack.zero,
             pack.ramp, pack.scale, pack.codes8, pack.codes16, pack.codes32,
             pack.image),
            (pack.n_functions, max(pack.n_intervals), pack.max_lanes,
             pack.codes8.shape[0], pack.codes16.shape[0], pack.codes32.shape[0],
             pack.inv_delta.shape[0], rows))


def routed_pack_lookup_plain(pack: TablePack, fn_ids, x: torch.Tensor, *,
                             extrapolate=False) -> torch.Tensor:
    """Plain PyTorch version of ``tp_routed_lookup``: ``eval_routed_ref``."""
    return eval_routed_ref(pack, fn_ids, x, extrapolate=extrapolate)


def routed_pack_lookup(pack: TablePack, fn_ids, x: torch.Tensor, *,
                       extrapolate=False) -> torch.Tensor:
    """Row i of ``x`` through member ``fn_ids[i]`` of the f32 pack."""
    return run("tp_routed_lookup", "routed_pack_lookup", x, pack.device, "pack",
               _routed_args(pack, fn_ids, x, extrapolate),
               lambda: routed_pack_lookup_plain(pack, fn_ids, x,
                                                extrapolate=extrapolate))


def routed_pack_grad_plain(pack: TablePack, fn_ids, x: torch.Tensor, *,
                           extrapolate=False):
    """Plain PyTorch version of ``tp_routed_grad``: ``(eval_routed_ref,
    eval_routed_slope)``."""
    return (eval_routed_ref(pack, fn_ids, x, extrapolate=extrapolate),
            eval_routed_slope(pack, fn_ids, x, extrapolate=extrapolate))


def routed_pack_grad(pack: TablePack, fn_ids, x: torch.Tensor, *,
                     extrapolate=False):
    """Routed ``(y, dy/dx)``, both in x's dtype, from one selector pass."""
    return run("tp_routed_grad", "routed_pack_grad", x, pack.device, "pack",
               _routed_args(pack, fn_ids, x, extrapolate),
               lambda: routed_pack_grad_plain(pack, fn_ids, x,
                                              extrapolate=extrapolate))


def routed_quant_pack_lookup_plain(pack: QuantTablePack, fn_ids, x: torch.Tensor,
                                   *, extrapolate=False) -> torch.Tensor:
    """Plain PyTorch version of ``tp_routed_quant_lookup``:
    ``eval_routed_quant_ref``."""
    return eval_routed_quant_ref(pack, fn_ids, x, extrapolate=extrapolate)


def routed_quant_pack_lookup(pack: QuantTablePack, fn_ids, x: torch.Tensor, *,
                             extrapolate=False) -> torch.Tensor:
    """Row i of ``x`` through quantized member ``fn_ids[i]``
    (dequantize-on-read)."""
    return run("tp_routed_quant_lookup", "routed_quant_pack_lookup", x,
               pack.device, "pack", _routed_quant_args(pack, fn_ids, x, extrapolate),
               lambda: routed_quant_pack_lookup_plain(pack, fn_ids, x,
                                                      extrapolate=extrapolate))


def routed_quant_pack_grad_plain(pack: QuantTablePack, fn_ids, x: torch.Tensor, *,
                                 extrapolate=False):
    """Plain PyTorch version of ``tp_routed_quant_grad``:
    ``(eval_routed_quant_ref, eval_routed_quant_slope)``."""
    return (eval_routed_quant_ref(pack, fn_ids, x, extrapolate=extrapolate),
            eval_routed_quant_slope(pack, fn_ids, x, extrapolate=extrapolate))


def routed_quant_pack_grad(pack: QuantTablePack, fn_ids, x: torch.Tensor, *,
                           extrapolate=False):
    """Routed quantized ``(y, dy/dx)``, both in x's dtype, from one selector
    pass."""
    return run("tp_routed_quant_grad", "routed_quant_pack_grad", x, pack.device,
               "pack", _routed_quant_args(pack, fn_ids, x, extrapolate),
               lambda: routed_quant_pack_grad_plain(pack, fn_ids, x,
                                                    extrapolate=extrapolate))


def routed_poly_pack_lookup_plain(pack: PolyTablePack, fn_ids, x: torch.Tensor, *,
                                  extrapolate=False) -> torch.Tensor:
    """Plain PyTorch version of ``tp_routed_poly_lookup``:
    ``eval_routed_poly_ref``."""
    return eval_routed_poly_ref(pack, fn_ids, x, extrapolate=extrapolate)


def routed_poly_pack_lookup(pack: PolyTablePack, fn_ids, x: torch.Tensor, *,
                            extrapolate=False) -> torch.Tensor:
    """Row i of ``x`` through polynomial member ``fn_ids[i]`` (dequantize +
    Horner)."""
    return run("tp_routed_poly_lookup", "routed_poly_pack_lookup", x, pack.device,
               "pack", _routed_poly_args(pack, fn_ids, x, extrapolate),
               lambda: routed_poly_pack_lookup_plain(pack, fn_ids, x,
                                                     extrapolate=extrapolate))


def routed_poly_pack_grad_plain(pack: PolyTablePack, fn_ids, x: torch.Tensor, *,
                                extrapolate=False):
    """Plain PyTorch version of ``tp_routed_poly_grad``:
    ``(eval_routed_poly_ref, eval_routed_poly_slope)``."""
    return (eval_routed_poly_ref(pack, fn_ids, x, extrapolate=extrapolate),
            eval_routed_poly_slope(pack, fn_ids, x, extrapolate=extrapolate))


def routed_poly_pack_grad(pack: PolyTablePack, fn_ids, x: torch.Tensor, *,
                          extrapolate=False):
    """Routed polynomial ``(y, dy/dx)``, both in x's dtype, from one selector
    and Horner pass."""
    return run("tp_routed_poly_grad", "routed_poly_pack_grad", x, pack.device,
               "pack", _routed_poly_args(pack, fn_ids, x, extrapolate),
               lambda: routed_poly_pack_grad_plain(pack, fn_ids, x,
                                                   extrapolate=extrapolate))


def _sharded_routed_args(pack: ShardedTablePack, fn_ids, x: torch.Tensor,
                         extrapolate, s_begin: int, s_end: int):
    """(planes, ints) of ``tp_sharded_routed_lookup`` / ``_grad``: the
    routing operands, the replicated planes, the owner-rebased-base and
    owner planes, every shard's padded values slice, the shard count and the
    shard range ``[s_begin, s_end)`` that the launch sums.  The reference
    has no mesh branch for routed dispatch: a placed pack is refused."""
    pack.check_whole()
    rows = _rows(x)
    (n_arr,) = pack.routing_scalars()
    return ((_fn_id_operand(pack, fn_ids, rows).contiguous(), n_arr,
             routed_extr_operand(pack, extrapolate), pack.boundaries,
             pack.inv_delta, pack.owner_base, pack.seg_count, pack.owner,
             pack.values),
            (pack.n_functions, pack.n_max, pack.footprint_per_shard, pack.n_shards,
             s_begin, s_end, rows))


def _sharded_routed_grad_args(pack: ShardedTablePack, fn_ids, x: torch.Tensor,
                              extrapolate):
    """(planes, ints) of ``tp_sharded_routed_grad``: :func:`_sharded_routed_args`
    over all the shards, then the pack's staging image (``pack.image``) and
    where its values start."""
    image, v_at = pack.image
    planes, ints = _sharded_routed_args(pack, fn_ids, x, extrapolate, 0, pack.n_shards)
    return planes + (image,), ints + (v_at,)


def sharded_routed_shard_contrib_plain(pack: ShardedTablePack, fn_ids, shard: int,
                                       x: torch.Tensor, *,
                                       extrapolate=False) -> torch.Tensor:
    """Plain PyTorch version of ``tp_sharded_routed_lookup`` over one shard:
    row i gets ``shard_contrib`` of member ``fn_ids[i]``, shard ``shard``,
    in x's dtype."""
    xf = x.to(torch.float32)
    return _routed_where(
        pack, fn_ids, x,
        lambda f, e: shard_contrib(pack, f, shard, xf, extrapolate=e).to(x.dtype),
        extrapolate)


def sharded_routed_shard_contrib(pack: ShardedTablePack, fn_ids, shard: int,
                                 x: torch.Tensor, *, extrapolate=False) -> torch.Tensor:
    """Shard ``shard``'s routed contribution: row i of ``x`` through member
    ``fn_ids[i]`` of that shard alone, masked, in x's dtype (one launch over
    the shard range ``[shard, shard + 1)``)."""
    if not 0 <= shard < pack.n_shards:
        raise IndexError(f"shard {shard} out of range for {pack.n_shards} shards")
    return run("tp_sharded_routed_lookup", "sharded_routed_pack_lookup", x,
               pack.device, "pack",
               _sharded_routed_args(pack, fn_ids, x, extrapolate, shard, shard + 1),
               lambda: sharded_routed_shard_contrib_plain(pack, fn_ids, shard, x,
                                                          extrapolate=extrapolate))


def sharded_routed_pack_lookup_plain(pack: ShardedTablePack, fn_ids,
                                     x: torch.Tensor, *,
                                     extrapolate=False) -> torch.Tensor:
    """Plain PyTorch version of ``tp_sharded_routed_lookup`` over all the
    shards: ``eval_routed_sharded_ref``."""
    return eval_routed_sharded_ref(pack, fn_ids, x, extrapolate=extrapolate)


def sharded_routed_pack_lookup(pack: ShardedTablePack, fn_ids, x: torch.Tensor, *,
                               extrapolate=False) -> torch.Tensor:
    """Row i of ``x`` through member ``fn_ids[i]`` of the sharded pack: one
    routed launch over the S shards, summed on the card."""
    return run("tp_sharded_routed_lookup", "sharded_routed_pack_lookup", x,
               pack.device, "pack",
               _sharded_routed_args(pack, fn_ids, x, extrapolate, 0, pack.n_shards),
               lambda: sharded_routed_pack_lookup_plain(pack, fn_ids, x,
                                                        extrapolate=extrapolate))


def sharded_routed_pack_grad_plain(pack: ShardedTablePack, fn_ids, x: torch.Tensor,
                                   *, extrapolate=False):
    """Plain PyTorch version of :func:`sharded_routed_pack_grad`:
    ``(eval_routed_sharded_ref, eval_routed_sharded_slope)``."""
    return (eval_routed_sharded_ref(pack, fn_ids, x, extrapolate=extrapolate),
            eval_routed_sharded_slope(pack, fn_ids, x, extrapolate=extrapolate))


def sharded_routed_pack_grad(pack: ShardedTablePack, fn_ids, x: torch.Tensor, *,
                             extrapolate=False):
    """Routed sharded ``(y, dy/dx)``, both in x's dtype, from one fused pass:
    one routed launch over the S shards, each output summed in shard order
    on the card."""
    return run("tp_sharded_routed_grad", "sharded_routed_pack_grad", x, pack.device,
               "pack", _sharded_routed_grad_args(pack, fn_ids, x, extrapolate),
               lambda: sharded_routed_pack_grad_plain(pack, fn_ids, x,
                                                      extrapolate=extrapolate))
