"""repro_torch.analysis — PackLint: the port's standing contracts, checked on
``make_fx`` graphs (the reference's ``repro.analysis``).

``graph_lint`` holds the trace-inspection primitives, ``contracts`` the five
registered rules over the live mode registry, ``report`` the
``packlint-report-v1`` serialization and ``sass`` the card-only scan of the
built kernels.  ``tools/torch_check_contracts.py`` is the CLI.

Why ``meta``.  Every kernel entry is a ``torch.library`` op
(``repro_torch.kernels.ops``) with a fake implementation, so a launch is one
node of a graph, with its operands and int arguments, as a ``pallas_call``
is one equation of a jaxpr.  The closures are traced over ``meta`` tensors
(the packs built on the host, their planes placed on ``meta``): nothing
runs, and the graph is the one the card runs (``chip_smoke.py`` phase 44
traces the same closures over CUDA tensors and compares the fingerprints).
Autograd cannot be traced over fake CUDA tensors on a CPU-only PyTorch
build (the process aborts), and on ``meta`` it can.

The rules (``contracts.RULES``):

1. ``f64_leak`` — no float64 or complex128 in any closure's graph (value or
   grad: node values and tensor constants) nor in any tensor leaf of the
   f32, quantized, polynomial and sharded packs.
2. ``kernel_primitives`` — every kernel node (every closure's, and
   TableFlash's ``attn_exp``) is a registered op with a row in
   ``KERNEL_ALLOWED`` (keyed by the reference's Pallas kernel: the port's op
   and the ``__global__`` kernels it launches), of its entry's arity, over
   an f32 or bf16 x; a node with no row fails as "unregistered kernel
   entry".  The CUDA source's ``extern "C" tp_*`` entries, the registered
   ops, ``_ENTRIES`` and the rows are one set.  Closures built with
   observability off hold no host sync, data-dependent op or symbolic shape.
   On the card (``--sass``) no ``__global__`` kernel of the built library
   holds an f64 instruction, local-memory traffic (LDL / STL) or a CALL,
   and each belongs to a row.
3. ``recompile_hazard`` — a routed launch's signature (its int arguments
   and its operands' shape, dtype and stride) is the same over the routings
   ``[a]``, ``[b]`` and ``[a, b] * (ROWS // 2)``, value and grad of the
   f32, quantized and polynomial packs: one compiled kernel and one CUDA
   graph serve every routing.  ``ContinuousEngine`` has the two entry points
   ``prefill`` and ``decode_step``, its tick's outputs re-feed it with equal
   shapes and dtypes, prefill returns the cache's signature and the refill
   scatter keeps it (on ``meta``, abstract params).
4. ``smem_budget`` (the reference's ``vmem_budget``) — the staging image a
   launch takes is, byte for byte, its flavor's ``smem()`` report
   (``PackLayout``, ``QuantPackLayout``, ``PackPlan``,
   ``ShardedPackLayout``; the sharded value kernels' values slab), the
   report's budget is the kernels' ``kSmemBytes``, and a routed launch's
   extra operands are the named ``routed_dispatch_allowance``.
5. ``obs_off_identity`` — for every mode, ``routed_fn`` and ``attn_exp``,
   the closure built with observability never configured and the one built
   with it enabled and the telemetry off have one fingerprint (the graph's
   code, constants' names and devices masked).
"""

from .contracts import (ALL_MODES, FAST_FUNCS, KERNEL_ALLOWED, LintContext, RULES, rule,
                        run)
from .report import Finding, Report

__all__ = [
    "ALL_MODES",
    "FAST_FUNCS",
    "Finding",
    "KERNEL_ALLOWED",
    "LintContext",
    "RULES",
    "Report",
    "rule",
    "run",
]
