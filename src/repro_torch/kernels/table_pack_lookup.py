"""Hopper kernels over a :class:`repro_torch.approx.table_pack.TablePack`, with
their wrappers and plain PyTorch versions.

  * :func:`table_pack_lookup` — one pack member over a tensor (the GLU gate's
    ``silu`` on the serving path).  CUDA kernel ``tp_pack_lookup`` in
    ``csrc/table_pack_lookup.cu``; replaces the TPU kernel ``_pack_kernel``
    (``src/repro/kernels/table_pack_lookup.py:43``).  Where the pack's
    staging image (``TablePack.image``) fits a block's 48 KB, a block stages
    it in one round trip with x in flight; :func:`table_pack_grad` too.
    Plain version: :func:`table_pack_lookup_plain`, the torch twin of
    ``eval_pack_ref``.
  * :func:`tableflash_exp` — flash attention's running-softmax exponent from
    the ``exp_neg`` member, with the underflow-to-zero tail below ``lo``.
    CUDA kernel ``tp_tableflash_exp``; replaces ``_tableflash_kernel``
    (``src/repro/kernels/table_pack_lookup.py:188``).  Plain version:
    :func:`tableflash_exp_plain`, ``where(z < lo, 0, eval_pack_ref(max(z, lo)))``.
  * :func:`table_pack_grad` — value and slope of one member from one selector
    pass (the training path's forward).  CUDA kernel ``tp_pack_grad``;
    replaces ``_pack_grad_kernel`` (``src/repro/kernels/table_pack_lookup.py:66``).
    Plain version: :func:`table_pack_grad_plain`, ``(eval_pack_ref,
    eval_pack_slope)``.
  * :func:`quant_pack_lookup` / :func:`quant_pack_grad` — one member of a
    :class:`~repro_torch.approx.table_pack.QuantTablePack` (int8/int16 codes
    dequantized on read), value or value + slope.  CUDA kernels
    ``tp_quant_lookup`` / ``tp_quant_grad``; replace ``_quant_kernel`` /
    ``_quant_grad_kernel`` (``src/repro/kernels/table_pack_lookup.py:283``,
    ``:309``); they stage the pack's staging image (``QuantTablePack.image``)
    where it fits, as the static poly kernels stage theirs.  Plain versions:
    ``eval_quant_pack_ref`` and ``eval_quant_pack_slope``.
  * :func:`poly_pack_lookup` / :func:`poly_pack_grad` — one member of a
    :class:`~repro_torch.approx.table_pack.PolyTablePack` (degree-d cells,
    int8/int16/f32 coefficient codes, Horner), value or value + slope.  CUDA
    kernels ``tp_poly_lookup`` / ``tp_poly_grad``; replace ``_poly_kernel`` /
    ``_poly_grad_kernel`` (``:503``, ``:524``).  Plain versions:
    ``eval_poly_pack_ref`` and ``eval_poly_pack_slope``.
  * :func:`folded_pack_lookup` / :func:`folded_pack_grad` — full-f32-range
    ``sin`` / ``cos`` / ``exp`` / ``log`` over the f32 pack's core members
    (RangeFold): the fold prologue, one or two core lookups that never
    extrapolate, the reconstruction and edge epilogue, value or value +
    chain-ruled slope, in one launch.  CUDA kernels ``tp_folded_lookup`` /
    ``tp_folded_grad``; replace ``_folded_kernel`` / ``_folded_grad_kernel``
    (``:943``, ``:953``).  Plain versions: ``eval_folded_ref`` and
    ``eval_folded_slope`` (``approx/range_fold.py``), in x's dtype.
  * :func:`sharded_pack_lookup` / :func:`sharded_pack_slope` — a member of
    a :class:`~repro_torch.approx.table_pack.ShardedTablePack` (value or
    slope): one launch a call over all S shards, the masked contributions
    summed in shard order in x's dtype on the card; and
    :func:`sharded_shard_contrib`, ONE shard's contribution (the same kernel
    over a range of one shard).  CUDA kernel ``tp_spack_lookup``; replaces
    ``_spack_kernel`` (``:663``) and the sum over its outputs
    (``_sharded_sum_pallas``, ``:803``).  Plain versions:
    ``eval_sharded_ref`` / ``eval_sharded_slope`` and ``shard_contrib``.
  * :func:`sharded_pack_grad` — value and slope over all S shards in one
    selector pass and one launch a call, each summed in shard order in x's
    dtype on the card; where the pack's staging image
    (``ShardedTablePack.image``) fits a block's 48 KB, a block stages it in
    one round trip with x in flight.  CUDA kernel ``tp_spack_grad``;
    replaces ``_spack_grad_kernel`` (``:697``) and the sum over its
    outputs.  Plain version: ``(eval_sharded_ref, eval_sharded_slope)``.

Every wrapper goes through :func:`repro_torch.kernels._lib.run`: it checks
x's dtype (float32 or bfloat16) and that x and the pack share a device, then
runs the plain version only because the tensor lies on the CPU.  For a CUDA
tensor it launches the kernel or raises: there is no fallback.  Every launch
adds one to :data:`launches`, and nothing else does.
The kernels are bounded by bytes (``N * (in_bytes + n_out * out_bytes)`` at
the card's memory rate) and are launch-bound at decode shapes; see the note at
the top of the CUDA source.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.approx.table_pack import (PolyTablePack, QuantTablePack,
                                          ShardedTablePack, TablePack,
                                          eval_pack_ref, eval_pack_slope,
                                          eval_poly_pack_ref, eval_poly_pack_slope,
                                          eval_quant_pack_ref,
                                          eval_quant_pack_slope, eval_sharded_ref,
                                          eval_sharded_slope, member_image_layout,
                                          shard_contrib)

from repro_torch.approx.range_fold import (FOLDABLE, eval_folded_ref,
                                          eval_folded_slope)

from ._lib import launches, reset_launches, run

__all__ = ["launches", "reset_launches", "table_pack_lookup",
           "table_pack_lookup_plain", "tableflash_exp", "tableflash_exp_plain",
           "table_pack_grad", "table_pack_grad_plain", "quant_pack_lookup",
           "quant_pack_lookup_plain", "quant_pack_grad", "quant_pack_grad_plain",
           "poly_pack_lookup", "poly_pack_lookup_plain", "poly_pack_grad",
           "poly_pack_grad_plain", "folded_pack_lookup", "folded_pack_lookup_plain",
           "folded_pack_grad", "folded_pack_grad_plain", "sharded_shard_contrib",
           "sharded_shard_contrib_plain", "sharded_pack_lookup",
           "sharded_pack_lookup_plain", "sharded_pack_slope",
           "sharded_pack_slope_plain", "sharded_pack_grad", "sharded_pack_grad_plain"]


def _pack_args(pack: TablePack, fid: int, *flags: int):
    """(planes, ints) of an f32-pack entry point for member ``fid``."""
    return ((pack.boundaries, pack.inv_delta, pack.base, pack.seg_count, pack.values),
            (fid, pack.n_max, pack.n_intervals[fid], pack.footprint, *flags))


_image_layout = functools.lru_cache(maxsize=None)(member_image_layout)


def _pack_image_args(pack: TablePack, fid: int, extrapolate: bool):
    """(planes, ints) of ``tp_pack_lookup`` / ``tp_pack_grad``: member
    ``fid``'s, the pack's staging image (``pack.image``, built with the
    pack), the member's row start in it, where its values start and how
    many it holds."""
    image, m_img = pack.image
    starts, v_at = _image_layout(pack.n_intervals)
    planes, ints = _pack_args(pack, fid, int(extrapolate))
    return planes + (image,), ints + (starts[fid], v_at, m_img)


def table_pack_lookup_plain(pack: TablePack, fn, x: torch.Tensor, *,
                            extrapolate: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``tp_pack_lookup``: the torch twin of the JAX
    package's ``eval_pack_ref``, op for op."""
    return eval_pack_ref(pack, fn, x, extrapolate=extrapolate)


def table_pack_lookup(pack: TablePack, fn, x: torch.Tensor, *,
                      extrapolate: bool = False) -> torch.Tensor:
    """Evaluate member ``fn`` (name or fn_id) of the pack over a tensor."""
    fid = pack.member_id(fn)
    return run("tp_pack_lookup", "table_pack_lookup", x, pack.device, "pack",
               _pack_image_args(pack, fid, extrapolate),
               lambda: table_pack_lookup_plain(pack, fid, x, extrapolate=extrapolate))


def tableflash_exp_plain(pack: TablePack, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``tp_tableflash_exp``: exp_neg lookup at
    max(x, lo), exactly 0 where the raw x < lo."""
    fid = pack.member_id("exp_neg")
    lo = pack.domains[fid][0]
    y = eval_pack_ref(pack, fid, torch.clamp(x, min=lo))
    return torch.where(x < lo, 0.0, y)


def _flash_args(pack: TablePack):
    """(planes, ints) of ``tp_tableflash_exp``: the pack's planes and
    exp_neg's staging image (``pack.flash_image``, built with the pack),
    exp_neg's row and the values the image holds."""
    image, m_img = pack.flash_image
    planes, ints = _pack_args(pack, pack.member_id("exp_neg"))
    return planes + (image,), ints + (m_img,)


def tableflash_exp(pack: TablePack, x: torch.Tensor) -> torch.Tensor:
    """Fused clamp + exp_neg lookup over flash attention's exponent tensor."""
    return run("tp_tableflash_exp", "tableflash_exp", x, pack.device, "pack",
               _flash_args(pack), lambda: tableflash_exp_plain(pack, x))


def table_pack_grad_plain(pack: TablePack, fn, x: torch.Tensor, *,
                          extrapolate: bool = False):
    """Plain PyTorch version of ``tp_pack_grad``: ``(eval_pack_ref,
    eval_pack_slope)``, each the torch twin of the JAX package's eager one."""
    return (eval_pack_ref(pack, fn, x, extrapolate=extrapolate),
            eval_pack_slope(pack, fn, x, extrapolate=extrapolate))


def table_pack_grad(pack: TablePack, fn, x: torch.Tensor, *,
                    extrapolate: bool = False):
    """``(y, dy/dx)`` of member ``fn`` over a tensor, both in x's dtype, from
    one selector pass."""
    fid = pack.member_id(fn)
    return run("tp_pack_grad", "table_pack_grad", x, pack.device, "pack",
               _pack_image_args(pack, fid, extrapolate),
               lambda: table_pack_grad_plain(pack, fid, x, extrapolate=extrapolate))


# --------------------------------------------------------------------------------------
# QuantPack and PolyPack
# --------------------------------------------------------------------------------------


def _quant_args(pack: QuantTablePack, fid: int, extrapolate: bool):
    """(planes, ints) of a quant-pack entry point for member ``fid``: the
    pack's planes, the member's code group and the pack's staging image
    (``pack.image``), the member's offsets and sizes, and the counts that
    lay the image out (members, sub-intervals, each code group's
    entries)."""
    codes = pack.codes_for(fid)
    return ((pack.boundaries, pack.inv_delta, pack.base, pack.seg_count,
             pack.scale, pack.zero, pack.ramp, codes, pack.image),
            (pack.bounds_offset(fid), pack.lane_offset(fid), pack.n_intervals[fid],
             codes.shape[0], pack.entry_bits[fid], int(extrapolate), pack.n_functions,
             pack.inv_delta.shape[0], pack.codes8.shape[0], pack.codes16.shape[0]))


def _poly_args(pack: PolyTablePack, fid: int, extrapolate: bool):
    """(planes, ints) of a poly-pack entry point for member ``fid``: the
    pack's planes, the member's code group and the pack's staging image
    (``pack.image``), the member's offsets and sizes, and the counts that
    lay the image out (members, sub-intervals, each code group's
    entries)."""
    codes = pack.codes_for(fid)
    return ((pack.boundaries, pack.inv_delta, pack.base, pack.seg_count,
             pack.zero, pack.ramp, pack.scale, codes, pack.image),
            (pack.bounds_offset(fid), pack.lane_offset(fid), pack.n_intervals[fid],
             pack.max_lanes, pack.degrees[fid], codes.shape[0], pack.entry_bits[fid],
             int(extrapolate), pack.n_functions, pack.inv_delta.shape[0],
             pack.codes8.shape[0], pack.codes16.shape[0], pack.codes32.shape[0]))


def quant_pack_lookup_plain(pack: QuantTablePack, fn, x: torch.Tensor, *,
                            extrapolate: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``tp_quant_lookup``: ``eval_quant_pack_ref``."""
    return eval_quant_pack_ref(pack, fn, x, extrapolate=extrapolate)


def quant_pack_lookup(pack: QuantTablePack, fn, x: torch.Tensor, *,
                      extrapolate: bool = False) -> torch.Tensor:
    """Evaluate member ``fn`` of the quantized pack (dequantize-on-read)."""
    fid = pack.member_id(fn)
    return run("tp_quant_lookup", "quant_pack_lookup", x, pack.device, "pack",
               _quant_args(pack, fid, extrapolate),
               lambda: quant_pack_lookup_plain(pack, fid, x, extrapolate=extrapolate))


def quant_pack_grad_plain(pack: QuantTablePack, fn, x: torch.Tensor, *,
                          extrapolate: bool = False):
    """Plain PyTorch version of ``tp_quant_grad``: ``(eval_quant_pack_ref,
    eval_quant_pack_slope)``."""
    return (eval_quant_pack_ref(pack, fn, x, extrapolate=extrapolate),
            eval_quant_pack_slope(pack, fn, x, extrapolate=extrapolate))


def quant_pack_grad(pack: QuantTablePack, fn, x: torch.Tensor, *,
                    extrapolate: bool = False):
    """``(y, dy/dx)`` of quantized member ``fn``, both in x's dtype, from one
    selector pass."""
    fid = pack.member_id(fn)
    return run("tp_quant_grad", "quant_pack_grad", x, pack.device, "pack",
               _quant_args(pack, fid, extrapolate),
               lambda: quant_pack_grad_plain(pack, fid, x, extrapolate=extrapolate))


def poly_pack_lookup_plain(pack: PolyTablePack, fn, x: torch.Tensor, *,
                           extrapolate: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``tp_poly_lookup``: ``eval_poly_pack_ref``."""
    return eval_poly_pack_ref(pack, fn, x, extrapolate=extrapolate)


def poly_pack_lookup(pack: PolyTablePack, fn, x: torch.Tensor, *,
                     extrapolate: bool = False) -> torch.Tensor:
    """Evaluate member ``fn`` of the polynomial pack (dequantize + Horner)."""
    fid = pack.member_id(fn)
    return run("tp_poly_lookup", "poly_pack_lookup", x, pack.device, "pack",
               _poly_args(pack, fid, extrapolate),
               lambda: poly_pack_lookup_plain(pack, fid, x, extrapolate=extrapolate))


def poly_pack_grad_plain(pack: PolyTablePack, fn, x: torch.Tensor, *,
                         extrapolate: bool = False):
    """Plain PyTorch version of ``tp_poly_grad``: ``(eval_poly_pack_ref,
    eval_poly_pack_slope)``."""
    return (eval_poly_pack_ref(pack, fn, x, extrapolate=extrapolate),
            eval_poly_pack_slope(pack, fn, x, extrapolate=extrapolate))


def poly_pack_grad(pack: PolyTablePack, fn, x: torch.Tensor, *,
                   extrapolate: bool = False):
    """``(y, dy/dx)`` of polynomial member ``fn``, both in x's dtype, from one
    selector pass."""
    fid = pack.member_id(fn)
    return run("tp_poly_grad", "poly_pack_grad", x, pack.device, "pack",
               _poly_args(pack, fid, extrapolate),
               lambda: poly_pack_grad_plain(pack, fid, x, extrapolate=extrapolate))


# --------------------------------------------------------------------------------------
# RangeFold: fold + core lookup(s) + reconstruction, fused
# --------------------------------------------------------------------------------------

# the kind argument of the folded entry points (csrc/range_reduce.cuh rr::Kind)
FOLD_KIND = {"sin": 0, "cos": 1, "exp": 2, "log": 3}


def _folded_args(pack: TablePack, name: str):
    """(planes, ints) of a folded entry point: the pack's planes and the
    kind's staging image (``pack.fold_images``, built with the pack), the
    core members' fn_ids (``fid_b = fid_a`` for exp and log) and interval
    counts, resolved as the reference's ``_folded_prep`` does, and the
    values the image holds; a non-foldable name raises its ``KeyError``."""
    if name not in FOLDABLE:
        raise KeyError(f"folded kernel serves {sorted(FOLDABLE)}, got {name!r}; "
                       f"use table_pack_lookup for plain members")
    cores = FOLDABLE[name]
    fid_a = pack.member_id(cores[0])
    fid_b = pack.member_id(cores[1]) if len(cores) > 1 else fid_a
    image, m_img = pack.fold_images[name]
    return ((pack.boundaries, pack.inv_delta, pack.base, pack.seg_count, pack.values,
             image),
            (fid_a, fid_b, pack.n_max, pack.n_intervals[fid_a],
             pack.n_intervals[fid_b], pack.footprint, FOLD_KIND[name], m_img))


def folded_pack_lookup_plain(pack: TablePack, name: str,
                             x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``tp_folded_lookup``: ``eval_folded_ref`` in
    x's dtype (the kernel computes in f32 and stores in x's dtype)."""
    return eval_folded_ref(pack, name, x).to(x.dtype)


def folded_pack_lookup(pack: TablePack, name: str, x: torch.Tensor) -> torch.Tensor:
    """Full-f32-range ``sin`` / ``cos`` / ``exp`` / ``log`` over a tensor:
    fold + core lookup(s) + reconstruction in one launch."""
    return run("tp_folded_lookup", "folded_pack_lookup", x, pack.device, "pack",
               _folded_args(pack, name), lambda: folded_pack_lookup_plain(pack, name, x))


def folded_pack_grad_plain(pack: TablePack, name: str, x: torch.Tensor):
    """Plain PyTorch version of ``tp_folded_grad``: ``(eval_folded_ref,
    eval_folded_slope)`` in x's dtype."""
    return (eval_folded_ref(pack, name, x).to(x.dtype),
            eval_folded_slope(pack, name, x).to(x.dtype))


def folded_pack_grad(pack: TablePack, name: str, x: torch.Tensor):
    """``(y, dy/dx)`` of the folded surrogate, both in x's dtype, from one
    pass (the core slopes chain-ruled through the reconstruction)."""
    return run("tp_folded_grad", "folded_pack_grad", x, pack.device, "pack",
               _folded_args(pack, name), lambda: folded_pack_grad_plain(pack, name, x))


# --------------------------------------------------------------------------------------
# ShardedPack: one launch a call over the shards
# --------------------------------------------------------------------------------------


def _sharded_args(pack: ShardedTablePack, fid: int, s_begin: int, s_end: int,
                  *flags: int):
    """(planes, ints) of ``tp_spack_lookup`` / ``tp_spack_grad`` for member
    ``fid``: the replicated planes, the owner-rebased-base and owner planes,
    the padded values slices the pack holds, their count and the range
    ``[s_begin, s_end)`` of them that the launch sums (a placed pack holds
    one slice, and its owner plane names it 0)."""
    return ((pack.boundaries, pack.inv_delta, pack.owner_base, pack.seg_count,
             pack.owner, pack.values),
            (fid, pack.n_max, pack.n_intervals[fid], pack.footprint_per_shard,
             pack.n_local, s_begin, s_end, *flags))


def _sharded_grad_args(pack: ShardedTablePack, fid: int, extrapolate: bool):
    """(planes, ints) of ``tp_spack_grad`` for member ``fid`` over all the
    shards: :func:`_sharded_args` over ``[0, S)``, then the pack's staging
    image (``pack.image``, built with the pack), the member count and where
    the image's values start."""
    pack.check_whole()
    image, v_at = pack.image
    planes, ints = _sharded_args(pack, fid, 0, pack.n_shards, int(extrapolate))
    return planes + (image,), ints + (pack.n_functions, v_at)


def sharded_shard_contrib_plain(pack: ShardedTablePack, fn, shard: int,
                                x: torch.Tensor, *, extrapolate: bool = False,
                                slope: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``tp_spack_lookup`` over one shard:
    ``shard_contrib_ref`` of shard ``shard``, in x's dtype."""
    fid = pack.member_id(fn)
    return shard_contrib(pack, fid, shard, x.to(torch.float32),
                         extrapolate=extrapolate, slope=slope).to(x.dtype)


def sharded_shard_contrib(pack: ShardedTablePack, fn, shard: int, x: torch.Tensor,
                          *, extrapolate: bool = False,
                          slope: bool = False) -> torch.Tensor:
    """Shard ``shard``'s masked contribution of member ``fn`` (its lerp, or
    with ``slope`` its segment slope), in x's dtype: one launch over the
    shard range ``[shard, shard + 1)`` (of a placed pack: its one slice)."""
    fid = pack.member_id(fn)
    if not 0 <= shard < pack.n_shards:
        raise IndexError(f"shard {shard} out of range for {pack.n_shards} shards")
    s = pack.local_shard(shard)
    return run("tp_spack_lookup", "sharded_pack_lookup", x, pack.device, "pack",
               _sharded_args(pack, fid, s, s + 1, int(extrapolate), int(slope)),
               lambda: sharded_shard_contrib_plain(pack, fid, shard, x,
                                                   extrapolate=extrapolate,
                                                   slope=slope))


def sharded_pack_lookup_plain(pack: ShardedTablePack, fn, x: torch.Tensor, *,
                              extrapolate: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`sharded_pack_lookup`:
    ``eval_sharded_ref``."""
    return eval_sharded_ref(pack, fn, x, extrapolate=extrapolate)


def sharded_pack_lookup(pack: ShardedTablePack, fn, x: torch.Tensor, *,
                        extrapolate: bool = False) -> torch.Tensor:
    """Evaluate member ``fn`` of the sharded pack: one launch over the S
    shards, summed in shard order on the card."""
    pack.check_whole()
    fid = pack.member_id(fn)
    return run("tp_spack_lookup", "sharded_pack_lookup", x, pack.device, "pack",
               _sharded_args(pack, fid, 0, pack.n_shards, int(extrapolate), 0),
               lambda: sharded_pack_lookup_plain(pack, fid, x, extrapolate=extrapolate))


def sharded_pack_slope_plain(pack: ShardedTablePack, fn, x: torch.Tensor, *,
                             extrapolate: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`sharded_pack_slope`:
    ``eval_sharded_slope``."""
    return eval_sharded_slope(pack, fn, x, extrapolate=extrapolate)


def sharded_pack_slope(pack: ShardedTablePack, fn, x: torch.Tensor, *,
                       extrapolate: bool = False) -> torch.Tensor:
    """The slope alone (no value pass): one launch of the value kernel in its
    slope mode over the S shards, summed."""
    pack.check_whole()
    fid = pack.member_id(fn)
    return run("tp_spack_lookup", "sharded_pack_lookup", x, pack.device, "pack",
               _sharded_args(pack, fid, 0, pack.n_shards, int(extrapolate), 1),
               lambda: sharded_pack_slope_plain(pack, fid, x, extrapolate=extrapolate))


def sharded_pack_grad_plain(pack: ShardedTablePack, fn, x: torch.Tensor, *,
                            extrapolate: bool = False):
    """Plain PyTorch version of :func:`sharded_pack_grad`:
    ``(eval_sharded_ref, eval_sharded_slope)``."""
    return (eval_sharded_ref(pack, fn, x, extrapolate=extrapolate),
            eval_sharded_slope(pack, fn, x, extrapolate=extrapolate))


def sharded_pack_grad(pack: ShardedTablePack, fn, x: torch.Tensor, *,
                      extrapolate: bool = False):
    """``(y, dy/dx)`` of sharded member ``fn``, both in x's dtype, from one
    selector pass: one launch over the S shards, each output summed in shard
    order on the card."""
    fid = pack.member_id(fn)
    return run("tp_spack_grad", "sharded_pack_grad", x, pack.device, "pack",
               _sharded_grad_args(pack, fid, extrapolate),
               lambda: sharded_pack_grad_plain(pack, fid, x, extrapolate=extrapolate))
