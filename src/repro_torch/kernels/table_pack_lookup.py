"""Hopper kernels over a :class:`repro_torch.approx.table_pack.TablePack`, with
their wrappers and plain PyTorch versions.

  * :func:`table_pack_lookup` — one pack member over a tensor (the GLU gate's
    ``silu`` on the serving path).  CUDA kernel ``tp_pack_lookup`` in
    ``csrc/table_pack_lookup.cu``; replaces the TPU kernel ``_pack_kernel``
    (``src/repro/kernels/table_pack_lookup.py:43``).  Plain version:
    :func:`table_pack_lookup_plain`, the torch twin of ``eval_pack_ref``.
  * :func:`tableflash_exp` — flash attention's running-softmax exponent from
    the ``exp_neg`` member, with the underflow-to-zero tail below ``lo``.
    CUDA kernel ``tp_tableflash_exp``; replaces ``_tableflash_kernel``
    (``src/repro/kernels/table_pack_lookup.py:188``).  Plain version:
    :func:`tableflash_exp_plain`, ``where(z < lo, 0, eval_pack_ref(max(z, lo)))``.

A wrapper checks x's dtype (float32 or bfloat16) and that x and the pack share
a device, then runs the plain version only because the tensor lies on the
CPU.  For a CUDA tensor it launches the kernel or raises: there is no
fallback.  Every launch adds one to :data:`launches`, and nothing else does.
Both kernels are bounded by bytes (``N * (in_bytes + out_bytes)`` at the card's
memory rate) and are launch-bound at decode shapes; see the note at the top of
the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.approx.table_pack import TablePack, eval_pack_ref

from . import _build

SOURCE = "table_pack_lookup"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel since the last reset_launches()
launches: Dict[str, int] = {"table_pack_lookup": 0, "tableflash_exp": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, ctypes.c_longlong, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I]


_typed: Dict[int, ctypes.CDLL] = {}


def _lib() -> ctypes.CDLL:
    """The built library with every entry point's argtypes/restype declared
    (pointers and the stream as c_void_p, so ctypes never cuts them to 32
    bits)."""
    lib = _build.load(SOURCE)
    if id(lib) not in _typed:
        lib.tp_pack_lookup.argtypes = _ARGS + [_I, _P]
        lib.tp_pack_lookup.restype = _I
        lib.tp_tableflash_exp.argtypes = _ARGS + [_P]
        lib.tp_tableflash_exp.restype = _I
        lib.tp_error_string.argtypes = [_I]
        lib.tp_error_string.restype = ctypes.c_char_p
        _typed[id(lib)] = lib
    return lib


def _check(pack: TablePack, x: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"table kernels take float32 or bfloat16, got {x.dtype}")
    if pack.values.device != x.device:
        raise ValueError(f"pack lives on {pack.values.device}, x on {x.device}")


def _launch(entry: str, pack: TablePack, fid: int, x: torch.Tensor, *extra):
    """Flatten x, allocate the output, launch ``entry`` on the current stream,
    raise on a launch error.  Returns the output in x's shape."""
    flat = x.reshape(-1)
    if not flat.is_contiguous():
        flat = flat.contiguous()
    out = torch.empty(flat.shape, dtype=x.dtype, device=x.device)
    if flat.numel() == 0:
        return out.reshape(x.shape)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            flat.data_ptr(), out.data_ptr(), flat.numel(), _DTYPE_CODE[x.dtype],
            pack.boundaries.data_ptr(), pack.inv_delta.data_ptr(),
            pack.base.data_ptr(), pack.seg_count.data_ptr(),
            pack.values.data_ptr(), fid, pack.n_max, pack.n_intervals[fid],
            pack.footprint, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.tp_error_string(err).decode()} ({err})")
    return out.reshape(x.shape)


def table_pack_lookup_plain(pack: TablePack, fn, x: torch.Tensor, *,
                            extrapolate: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``tp_pack_lookup``: the torch twin of the JAX
    package's ``eval_pack_ref``, op for op."""
    return eval_pack_ref(pack, fn, x, extrapolate=extrapolate)


def table_pack_lookup(pack: TablePack, fn, x: torch.Tensor, *,
                      extrapolate: bool = False) -> torch.Tensor:
    """Evaluate member ``fn`` (name or fn_id) of the pack over a tensor."""
    fid = pack.member_id(fn)
    _check(pack, x)
    if x.device.type == "cpu":
        return table_pack_lookup_plain(pack, fid, x, extrapolate=extrapolate)
    out = _launch("tp_pack_lookup", pack, fid, x, int(extrapolate))
    if x.numel():
        launches["table_pack_lookup"] += 1
    return out


def tableflash_exp_plain(pack: TablePack, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``tp_tableflash_exp``: exp_neg lookup at
    max(x, lo), exactly 0 where the raw x < lo."""
    fid = pack.member_id("exp_neg")
    lo = pack.domains[fid][0]
    y = eval_pack_ref(pack, fid, torch.clamp(x, min=lo))
    return torch.where(x < lo, 0.0, y)


def tableflash_exp(pack: TablePack, x: torch.Tensor) -> torch.Tensor:
    """Fused clamp + exp_neg lookup over flash attention's exponent tensor."""
    _check(pack, x)
    if x.device.type == "cpu":
        return tableflash_exp_plain(pack, x)
    out = _launch("tp_tableflash_exp", pack, pack.member_id("exp_neg"), x)
    if x.numel():
        launches["tableflash_exp"] += 1
    return out
