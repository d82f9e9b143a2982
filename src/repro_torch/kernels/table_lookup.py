"""Hopper kernel over one :class:`repro_torch.approx.torch_table.TorchTable`
(the ``table_pallas`` mode's value path), with its wrapper and plain version.

  * :func:`table_lookup` — the paper's Fig. 7 lookup over one table.  CUDA
    kernel ``tp_table_lookup`` in ``csrc/table_pack_lookup.cu`` (the pack
    kernel over a single metadata row, n_max = n_intervals); replaces the TPU
    kernel ``_table_kernel`` (``src/repro/kernels/table_lookup.py:66``).
    Plain version: :func:`table_lookup_plain`, the torch twin of the JAX
    package's eager ``eval_table_ref``.

The JAX wrapper's ``tile_activations`` / ``untile_activations`` (zero-padding
x into (rows, 512) tiles) have no counterpart: the kernel's grid-stride loop
walks the flat element count and masks the ragged tail itself.  The wrapper
contract is that of :mod:`~repro_torch.kernels.table_pack_lookup`: dtype and
device checked, the plain version only for a CPU tensor, a launch or an error
for a CUDA tensor, one count in :data:`launches` per launch.  A table of any
interval count runs: where the table's staging image (``TorchTable.image``:
its row, then its values, built with the table) fits a block's 48 KB, the
kernel stages it in one round trip with x in flight; past it the kernel
stages the row, and the values as they fit, and reads the rest from global
memory.
"""

from __future__ import annotations

import torch

from repro_torch.approx.torch_table import TorchTable, eval_table_ref

from ._lib import run


def table_planes(jt: TorchTable):
    """The planes of ``tp_table_lookup`` / ``tp_table_grad``: the table's
    row, its values and its staging image."""
    return (jt.boundaries, jt.inv_delta, jt.base, jt.seg_count, jt.values, jt.image)


def table_lookup_plain(jt: TorchTable, x: torch.Tensor, *,
                       extrapolate: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``tp_table_lookup``: ``eval_table_ref``."""
    return eval_table_ref(jt, x, extrapolate=extrapolate)


def table_lookup(jt: TorchTable, x: torch.Tensor, *,
                 extrapolate: bool = False) -> torch.Tensor:
    """Evaluate the table approximator over a tensor."""
    return run("tp_table_lookup", "table_lookup", x, jt.values.device, "table",
               (table_planes(jt), (jt.n_intervals, jt.footprint, int(extrapolate))),
               lambda: table_lookup_plain(jt, x, extrapolate=extrapolate))
