"""The ctypes binding of ``csrc/table_pack_lookup.cu``, shared by the kernel
wrappers of :mod:`~repro_torch.kernels.table_pack_lookup`,
:mod:`~repro_torch.kernels.routed_pack_lookup`,
:mod:`~repro_torch.kernels.table_lookup` and :mod:`~repro_torch.kernels.table_grad`.

Every entry point takes ``(x, out[, slope], n, dtype, <planes>, <ints>,
stream)`` and returns the launch's CUDA error code.  The f32 pack and table
entries take five f32 planes (bounds, invd, base, segs, values) and the
staging image (``TablePack.image``, ``TorchTable.image``); the pack's also,
after the member's ints, its row start in the image, where the image's
values start and how many it holds.  The quantized and polynomial ones take
seven f32 planes (bounds, invd, base, segs and three dequant planes), the
codes pointer of the member's width group and the pack's staging image
(``QuantTablePack.image``, ``PolyTablePack.image``) and, after the member's
ints, the counts that lay it out.  The
routed entries take the int32 routing vectors first (ids, per-member interval
counts, extrapolate flags; for the f32 pack also each member's row start in
its staging image, for the quantized and polynomial packs
boundary offsets, lane offsets and code widths, and the polynomial pack's
coefficient strides), then the pack's planes (every code group of the
quantized or polynomial pack), then the row count; the routed f32 entries
also the pack's staging image (``TablePack.image``), its sub-interval count
and the values the image holds.  The folded entries take
the f32 pack's five planes and the core members' ids and interval counts and
the fold's kind, and the kind's staging image (``TablePack.fold_images``)
with the values it holds; the TableFlash entry also exp_neg's staging image
(``TablePack.flash_image``) with the values it holds; the routed quantized
and polynomial entries also the pack's staging image
(``QuantTablePack.image``, ``PolyTablePack.image``) and its sub-interval
count.  The
sharded entries take bounds, invd, the
owner-rebased base, segs, the owner plane and every shard's padded values
slice (the routed ones after the three routing vectors), the shard count and
a shard range ``[s_begin, s_end)`` that one launch sums; the grads also the
pack's staging image (``ShardedTablePack.image``) and where its values
start (the static one also the member count).
:func:`launch` flattens x (a dense x in memory order, its outputs with x's
strides, but for the routed entries), allocates the outputs, launches on the
current stream and raises on an error; :data:`launches` counts the launches of each
kernel, and only a launch adds to it.  :func:`run` is the one wrapper
contract every kernel wrapper goes through.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from . import _build

SOURCE = "table_pack_lookup"
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel since the last reset_launches()
launches: Dict[str, int] = {
    "table_pack_lookup": 0, "tableflash_exp": 0, "table_pack_grad": 0,
    "table_lookup": 0, "table_lookup_grad": 0, "quant_pack_lookup": 0,
    "quant_pack_grad": 0, "poly_pack_lookup": 0, "poly_pack_grad": 0,
    "routed_pack_lookup": 0, "routed_pack_grad": 0, "routed_quant_pack_lookup": 0,
    "routed_quant_pack_grad": 0, "folded_pack_lookup": 0, "folded_pack_grad": 0,
    "routed_poly_pack_lookup": 0, "routed_poly_pack_grad": 0,
    "sharded_pack_lookup": 0, "sharded_pack_grad": 0,
    "sharded_routed_pack_lookup": 0, "sharded_routed_pack_grad": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> (outputs, pointer planes, trailing int arguments before the
# stream)
_ENTRIES = {
    # 5 f32 planes + the pack's staging image; fn_id, n_max, n_intervals, m,
    # extrapolate, the member's row start, where the values start and the
    # values in the image
    "tp_pack_lookup": (1, 6, 8),
    # 5 f32 planes + exp_neg's staging image; fn_id, n_max, n_intervals, m,
    # the values in the image
    "tp_tableflash_exp": (1, 6, 5),
    "tp_pack_grad": (2, 6, 8),
    # 5 f32 planes + the table's staging image; n_intervals, m, extrapolate
    "tp_table_lookup": (1, 6, 3),
    "tp_table_grad": (2, 6, 3),
    # 7 f32 planes + the member's codes + the pack's staging image; bo, lo,
    # n_intervals, m, code_bits, extrapolate, then n_fn, the sub-interval
    # count, m8, m16 (the image's layout)
    "tp_quant_lookup": (1, 9, 10),
    "tp_quant_grad": (2, 9, 10),
    # 7 f32 planes + the member's codes + the pack's staging image; bo, lo,
    # n_intervals, lmax, degree, m, code_bits, extrapolate, then n_fn, the
    # sub-interval count, m8, m16, m32 (the image's layout)
    "tp_poly_lookup": (1, 9, 13),
    "tp_poly_grad": (2, 9, 13),
    # ids, n_arr, the members' row starts in the staging image, extr + 5 f32
    # planes + the staging image; n_fn, n_max, m, the sub-interval count, the
    # values in the image, rows
    "tp_routed_lookup": (1, 10, 6),
    "tp_routed_grad": (2, 10, 6),
    # ids, n_arr, extr, bo, lo, bits + 7 f32 planes + codes8, codes16 + the
    # pack's staging image; n_fn, max_n, m8, m16, the sub-interval count, rows
    "tp_routed_quant_lookup": (1, 16, 6),
    "tp_routed_quant_grad": (2, 16, 6),
    # 5 f32 planes + the kind's staging image; fid_a, fid_b, n_max, n_a, n_b,
    # m, kind (0 sin, 1 cos, 2 exp, 3 log), the values in the image
    "tp_folded_lookup": (1, 6, 8),
    "tp_folded_grad": (2, 6, 8),
    # ids, n_arr, extr, bo, lo, bits, strides + 7 f32 planes + codes8, codes16,
    # codes32 + the pack's staging image; n_fn, max_n, lmax, m8, m16, m32,
    # the sub-interval count, rows
    "tp_routed_poly_lookup": (1, 18, 8),
    "tp_routed_poly_grad": (2, 18, 8),
    # bounds, invd, obase, segs, owner, values (the owner-rebased-base and
    # owner planes, every shard's slice); fn_id, n_max, n_intervals, m_max,
    # n_shards, s_begin, s_end, extrapolate (+ slope for the value): one
    # launch sums shards [s_begin, s_end)
    "tp_spack_lookup": (1, 6, 9),
    # the same 6 planes + the pack's staging image; the same 8 ints, then
    # n_fn and the image's values start
    "tp_spack_grad": (2, 7, 10),
    # ids, n_arr, extr + the same 6 planes; n_fn, n_max, m_max, n_shards,
    # s_begin, s_end, rows
    "tp_sharded_routed_lookup": (1, 9, 7),
    # the same 9 planes + the pack's staging image; the same 7 ints, then the
    # image's values start
    "tp_sharded_routed_grad": (2, 10, 8),
}
_typed: Dict[int, ctypes.CDLL] = {}


def _lib() -> ctypes.CDLL:
    """The built library with every entry point's argtypes/restype declared
    (pointers and the stream as c_void_p, so ctypes never cuts them to 32
    bits)."""
    lib = _build.load(SOURCE)
    if id(lib) not in _typed:
        for entry, (n_out, n_planes, n_int) in _ENTRIES.items():
            fn = getattr(lib, entry)
            fn.argtypes = ([_P] * (1 + n_out) + [ctypes.c_longlong, _I]
                           + [_P] * n_planes + [_I] * n_int + [_P])
            fn.restype = _I
        lib.tp_error_string.argtypes = [_I]
        lib.tp_error_string.restype = ctypes.c_char_p
        _typed[id(lib)] = lib
    return lib


def check(x: torch.Tensor, table_device: torch.device, what: str) -> None:
    """x must be f32 or bf16 and lie on the device of its ``what`` (pack or
    table)."""
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"table kernels take float32 or bfloat16, got {x.dtype}")
    if table_device != x.device:
        raise ValueError(f"{what} lives on {table_device}, x on {x.device}")


def dense_order(x: torch.Tensor):
    """x's dims, outermost first, in the order its strides lay them out in
    memory, where its elements fill one block without gaps or overlaps (a
    contiguous tensor or a permutation of one: then ``x.permute(order)`` is
    contiguous); None otherwise."""
    order = sorted(range(x.dim()), key=lambda d: (-x.stride(d), -x.shape[d]))
    return order if x.permute(order).is_contiguous() else None


def operands(entry: str, x: torch.Tensor, n_out: int):
    """``(flat, outs)`` of a launch of ``entry`` over x: the flat input the
    kernel reads and its ``n_out`` outputs, whose memory it writes in the
    same order.

    An elementwise entry (all but the routed ones, whose rows carry their
    member ids) reads a dense x in memory order (a view, no copy) and gets
    outputs with x's strides, as PyTorch's elementwise ops (and so the plain
    versions) give: a permuted x is neither copied nor handed on in another
    layout, whose reductions downstream would sum in another order.  A
    routed entry, or an x with gaps or overlaps, reads x in its logical
    order and gets contiguous outputs."""
    order = None if entry.startswith(("tp_routed", "tp_sharded_routed")) else dense_order(x)
    if order is None:
        flat = x.reshape(-1)
        if not flat.is_contiguous():
            flat = flat.contiguous()
        return flat, [torch.empty(x.shape, dtype=x.dtype, device=x.device)
                      for _ in range(n_out)]
    return x.permute(order).reshape(-1), [
        torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
        for _ in range(n_out)]


def launch(entry: str, x: torch.Tensor, planes: Sequence[torch.Tensor],
           ints: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Launch ``entry`` over x (its ``operands``) on the current stream over
    the pack's ``planes`` (device tensors, in the entry's order) and raise on
    a launch error.  Returns the outputs, in x's shape and dtype."""
    n_out, n_planes, n_int = _ENTRIES[entry]
    if len(planes) != n_planes or len(ints) != n_int:
        raise ValueError(f"{entry} takes {n_planes} planes and {n_int} int "
                         f"arguments, got {len(planes)} and {len(ints)}")
    flat, outs = operands(entry, x, n_out)
    if flat.numel():
        lib = _lib()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = getattr(lib, entry)(
                flat.data_ptr(), *(o.data_ptr() for o in outs), flat.numel(),
                DTYPE_CODE[x.dtype], *(p.data_ptr() for p in planes), *ints,
                stream)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: "
                               f"{lib.tp_error_string(err).decode()} ({err})")
    return tuple(outs)


def run(entry: str, count: str, x: torch.Tensor, device: torch.device, what: str,
        args: Tuple[Sequence[torch.Tensor], Sequence[int]], plain):
    """The wrapper contract of every kernel: x must be f32 or bf16 and lie on
    ``device`` (its pack's or table's); a CPU tensor gets ``plain()``, the
    plain version; a CUDA tensor gets one launch of ``entry`` over ``args =
    (planes, ints)`` or an error, never the plain version.  A launch over a
    non-empty x adds one to ``launches[count]``.  One output is returned
    bare, two as a tuple."""
    check(x, device, what)
    if x.device.type == "cpu":
        return plain()
    outs = launch(entry, x, *args)
    if x.numel():
        launches[count] += 1
    return outs[0] if len(outs) == 1 else outs
