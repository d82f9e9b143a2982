"""The kernels' entry points as ``torch.library`` ops (the counterpart of the
reference's ``kernels/ops.py``, the one place its Pallas kernels are bound).

Each entry of :data:`repro_torch.kernels._lib._ENTRIES` is an op in the
``repro_torch`` namespace, ``torch.ops.repro_torch.<entry>``:

    tp_pack_lookup(Tensor x, Tensor[] planes, int[] ints) -> Tensor
    tp_pack_grad(Tensor x, Tensor[] planes, int[] ints) -> (Tensor, Tensor)

``planes`` are the pack's (or table's) device tensors in the entry's order
and ``ints`` its trailing int arguments (see ``_lib``).  An op has two
implementations and no other:

  * CUDA: the launch.  :func:`repro_torch.kernels._lib.operands` gives the
    flat input and the outputs, the ctypes entry point of the built
    ``csrc/table_pack_lookup.cu`` runs on the current stream, and a launch
    error raises.  This is the only place the port calls ctypes.
  * fake (``torch.library.register_fake``, which also serves the ``meta``
    device): outputs allocated exactly as ``operands`` allocates them, with
    x's strides for a dense x on an elementwise entry and contiguous for the
    routed entries and for an x with gaps.  Nothing is computed.

So a PyTorch graph sees a kernel launch as one node: ``make_fx`` over
``meta`` tensors records it with its operands and int arguments, as the
reference's jaxprs record a ``pallas_call`` (``repro_torch.analysis``
lints those graphs).  There is no CPU implementation: a CPU tensor never
reaches an op (``_lib.run`` gives it the plain version), and one that is
passed here raises.  The ops are defined with ``Library.define`` /
``impl`` rather than ``torch.library.custom_op``, whose Python wrapper
costs about three times as much on the host a call.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import _lib

NAMESPACE = "repro_torch"

_LIBRARY = torch.library.Library(NAMESPACE, "DEF")

# entry -> its op's default overload, filled below
OPS: Dict[str, torch._ops.OpOverload] = {}


def schema(entry: str) -> str:
    """The op schema of ``entry``: one output, or two (value and slope)."""
    n_out = _lib._ENTRIES[entry][0]
    out = "Tensor" if n_out == 1 else "(" + ", ".join(["Tensor"] * n_out) + ")"
    return f"{entry}(Tensor x, Tensor[] planes, int[] ints) -> {out}"


def _check_arity(entry: str, planes: Sequence[torch.Tensor], ints: Sequence[int]) -> None:
    _, n_planes, n_int = _lib._ENTRIES[entry]
    if len(planes) != n_planes or len(ints) != n_int:
        raise ValueError(f"{entry} takes {n_planes} planes and {n_int} int "
                         f"arguments, got {len(planes)} and {len(ints)}")


def _fake(entry: str):
    n_out = _lib._ENTRIES[entry][0]

    def fake(x: torch.Tensor, planes: List[torch.Tensor], ints: List[int]):
        _check_arity(entry, planes, ints)
        outs = _lib.output_like(entry, x, n_out)
        return outs[0] if n_out == 1 else tuple(outs)

    return fake


def _cuda(entry: str):
    n_out = _lib._ENTRIES[entry][0]

    def launch(x: torch.Tensor, planes: List[torch.Tensor], ints: List[int]):
        _check_arity(entry, planes, ints)
        flat, outs = _lib.operands(entry, x, n_out)
        if flat.numel():
            lib = _lib.built()
            with torch.cuda.device(x.device):
                stream = torch.cuda.current_stream(x.device).cuda_stream
                err = getattr(lib, entry)(
                    flat.data_ptr(), *(o.data_ptr() for o in outs), flat.numel(),
                    _lib.DTYPE_CODE[x.dtype], *(p.data_ptr() for p in planes), *ints,
                    stream)
            if err != 0:
                raise RuntimeError(f"{entry} launch failed: "
                                   f"{lib.tp_error_string(err).decode()} ({err})")
        return outs[0] if n_out == 1 else tuple(outs)

    return launch


for _entry in _lib._ENTRIES:
    _LIBRARY.define(schema(_entry))
    _LIBRARY.impl(_entry, _cuda(_entry), "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{_entry}", _fake(_entry), lib=_LIBRARY)
    OPS[_entry] = getattr(getattr(torch.ops, NAMESPACE), _entry).default
del _entry


def is_kernel_op(target) -> bool:
    """True for an op of this module (a kernel node of a traced graph)."""
    return isinstance(target, torch._ops.OpOverload) and target.namespace == NAMESPACE


def entry_of(target) -> str:
    """The ``_ENTRIES`` name of a kernel op (its overload packet's name)."""
    return target._schema.name.split("::", 1)[1]
