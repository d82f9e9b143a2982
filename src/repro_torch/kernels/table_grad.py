"""Fused value + slope Hopper kernel over one
:class:`repro_torch.approx.torch_table.TorchTable` (the ``table_pallas``
mode's training path), with its wrapper and plain version.

  * :func:`table_lookup_grad` — one selector pass yields both the table value
    y(x) and the piecewise-linear derivative dy/dx: after the parameter fetch
    and the pair gather, the slope is one more multiply ``(y1 - y0) * invd``
    (zeroed outside [b_0, b_n) unless extrapolating).  CUDA kernel
    ``tp_table_grad`` in ``csrc/table_pack_lookup.cu``; replaces the TPU
    kernel ``_table_grad_kernel`` (``src/repro/kernels/table_grad.py:28``).
    Plain version: :func:`table_lookup_grad_plain`, ``(eval_table_ref,
    eval_table_slope)``.

Wrapper contract as in :mod:`~repro_torch.kernels.table_lookup`.
"""

from __future__ import annotations

import torch

from repro_torch.approx.torch_table import TorchTable, eval_table_ref, eval_table_slope

from ._lib import run
from .table_lookup import table_planes


def table_lookup_grad_plain(jt: TorchTable, x: torch.Tensor, *,
                            extrapolate: bool = False):
    """Plain PyTorch version of ``tp_table_grad``."""
    return (eval_table_ref(jt, x, extrapolate=extrapolate),
            eval_table_slope(jt, x, extrapolate=extrapolate))


def table_lookup_grad(jt: TorchTable, x: torch.Tensor, *,
                      extrapolate: bool = False):
    """``(y, dy/dx)`` over a tensor, both in x's dtype, from one selector
    pass."""
    return run("tp_table_grad", "table_lookup_grad", x, jt.values.device, "table",
               (table_planes(jt), (jt.n_intervals, jt.footprint, int(extrapolate))),
               lambda: table_lookup_grad_plain(jt, x, extrapolate=extrapolate))
