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
  * :func:`table_pack_grad` — value and slope of one member from one selector
    pass (the training path's forward).  CUDA kernel ``tp_pack_grad``;
    replaces ``_pack_grad_kernel`` (``src/repro/kernels/table_pack_lookup.py:66``).
    Plain version: :func:`table_pack_grad_plain`, ``(eval_pack_ref,
    eval_pack_slope)``.

A wrapper checks x's dtype (float32 or bfloat16) and that x and the pack share
a device, then runs the plain version only because the tensor lies on the
CPU.  For a CUDA tensor it launches the kernel or raises: there is no
fallback.  Every launch adds one to :data:`launches`, and nothing else does.
The kernels are bounded by bytes (``N * (in_bytes + n_out * out_bytes)`` at
the card's memory rate) and are launch-bound at decode shapes; see the note at
the top of the CUDA source.
"""

from __future__ import annotations

import torch

from repro_torch.approx.table_pack import TablePack, eval_pack_ref, eval_pack_slope

from ._lib import check, launch, launches, reset_launches

__all__ = ["launches", "reset_launches", "table_pack_lookup",
           "table_pack_lookup_plain", "tableflash_exp", "tableflash_exp_plain",
           "table_pack_grad", "table_pack_grad_plain"]


def _planes(pack: TablePack):
    return (pack.boundaries, pack.inv_delta, pack.base, pack.seg_count, pack.values)


def _member(pack: TablePack, fid: int):
    return (fid, pack.n_max, pack.n_intervals[fid], pack.footprint)


def table_pack_lookup_plain(pack: TablePack, fn, x: torch.Tensor, *,
                            extrapolate: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``tp_pack_lookup``: the torch twin of the JAX
    package's ``eval_pack_ref``, op for op."""
    return eval_pack_ref(pack, fn, x, extrapolate=extrapolate)


def table_pack_lookup(pack: TablePack, fn, x: torch.Tensor, *,
                      extrapolate: bool = False) -> torch.Tensor:
    """Evaluate member ``fn`` (name or fn_id) of the pack over a tensor."""
    fid = pack.member_id(fn)
    check(x, pack.device, "pack")
    if x.device.type == "cpu":
        return table_pack_lookup_plain(pack, fid, x, extrapolate=extrapolate)
    (out,) = launch("tp_pack_lookup", x, _planes(pack),
                    (*_member(pack, fid), int(extrapolate)))
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
    check(x, pack.device, "pack")
    if x.device.type == "cpu":
        return tableflash_exp_plain(pack, x)
    (out,) = launch("tp_tableflash_exp", x, _planes(pack),
                    _member(pack, pack.member_id("exp_neg")))
    if x.numel():
        launches["tableflash_exp"] += 1
    return out


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
    check(x, pack.device, "pack")
    if x.device.type == "cpu":
        return table_pack_grad_plain(pack, fid, x, extrapolate=extrapolate)
    y, slope = launch("tp_pack_grad", x, _planes(pack),
                      (*_member(pack, fid), int(extrapolate)))
    if x.numel():
        launches["table_pack_grad"] += 1
    return y, slope
