"""The dry run: every (architecture x input shape x mesh) cell's REAL step
traced on the production mesh with nothing allocated — the JAX package's
``launch/dryrun.py`` on PyTorch.

The reference lowers and compiles each step for a 512-device SPMD target.
PyTorch has no such compiler to ask, so the port runs the step once, eagerly,
as rank 0 of a world of the ``"fake"`` backend
(``launch.mesh.init_fake_process_group``: 256 ranks for (16, 16), 512 for
(2, 16, 16)) under ``FakeTensorMode``.  The train state or parameters, the
cache and the batch are DTensors of fake tensors, placed by the port's spec
functions as the reference places them; every operator computes shapes only
and every collective is counted, not sent.  Each cell records, per device:

  * ``memory.argument_size_in_bytes``: the local shards' bytes of the step's
    arguments (train state or params, batch, cache);
  * ``memory.peak_size_in_bytes``: the peak of live bytes over the step, the
    arguments included (``torch.distributed._tools.mem_tracker.MemTracker``),
    in place of XLA's temp size; ``memory.temp_size_in_bytes`` is the peak
    less the arguments;
  * ``flops_per_device``: ``FlopCounterMode``'s count over the whole step.
    An eager run counts every layer and micro-batch, where XLA's
    ``cost_analysis`` counts a scanned body once (``analysis.cost_model``);
  * ``collectives``: each collective type's count (``CommDebugMode``) and its
    bytes under the reference's convention: an all-gather counts its
    gathered result, a reduce-scatter its shard, an all-reduce, all-to-all
    or permute its result.

Placement, as in the reference:
  * train, ``base``: weight-update sharding.  The f32 master and the AdamW
    moments are in the ZeRO-1 layout (``zero1_pspecs``), and each step casts
    a bf16 work copy into the tensor-parallel layout (``param_pspecs``).
    ``fsdp``: every leaf over the flat mesh (``fsdp_pspecs``).  ``ddp``:
    params replicated, moments ZeRO-1 over the flat mesh.  The batch lies
    over the batch axes.  Accumulation is the reference's automatic one (a
    micro-batch of ~4k tokens a data rank), capped at the rows a rank holds:
    the port cuts each micro-batch from every rank's own rows
    (``train.loop.micro_batch``).
  * prefill and decode: bf16 params over ``param_pspecs``, the cache over
    ``cache_pspecs``, the batch over the batch axes; a batch they do not
    divide (``long_500k``'s single row) is replicated.

The dense and MoE families run on a mesh so far (``train.loop.MESH_FAMILIES``;
the MoE block with expert parallelism, ``models.mlp.moe_on_mesh``, and the
MoE variants ``cf10`` and ``limit4``).  The other families' cells are
recorded ``not_ported`` (ROADMAP queue 1, item 12c).  An MoE training cell
that accumulates cuts each micro-batch from every rank's own rows, as the
dense ones do, so its micro-batch ``a`` holds other tokens than the
reference's global rows [a*b, (a+1)*b): the same step on the batch with its
rows permuted.  The capacity, the buffer shapes, and so the FLOPs, memory
and collectives, depend on the micro-batch's token count alone; which slots
drop depends on its tokens.

An eager trace of a whole step costs an hour or more for a train or
prefill cell on the CPU, so each step is traced at two cut depths and
carried to the cell's (``trace_on_mesh``).

Results merge into a JSON file keyed ``arch|shape|mesh|variant`` (default
``build/dryrun_torch.json``), so re-runs are incremental.

Usage (on the CPU, no card; ``--device cuda`` fakes CUDA tensors on a CUDA
build of PyTorch, and without one is an error):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import traceback
import weakref
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.models import build_model, get_config, input_specs, shapes_for
from repro_torch.models.registry import ARCH_IDS
from repro_torch.optim import adamw
from repro_torch.parallel.cache_specs import cache_pspecs
from repro_torch.parallel.params import (_nest, fsdp_pspecs, param_pspecs,
                                         shardings_from_specs, stacked_view, zero1_pspecs)
from repro_torch.parallel.sharding import (P, axes_size, axis_names, axis_sizes,
                                           default_rules, distribute, divisible_axes,
                                           is_dtensor, to_placements, use_sharding)
from repro_torch.train.loop import MESH_FAMILIES, make_train_step
from repro_torch.tree import leaves, tree_map

RESULTS_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                            "dryrun_torch.json")

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
         ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
         ("permute", "collective-permute"))

MOE_VARIANTS = ("cf10", "limit4")
NOT_PORTED = "ROADMAP queue 1, item 12c"


def _collective_kind(op) -> Optional[str]:
    """The collective type of a c10d functional op (or of
    ``CommDebugMode``'s key for it); None for any other op."""
    name = str(op)
    if "c10d" not in name:
        return None
    for key, kind in _KIND:
        if key in name:
            return kind
    return None


@contextmanager
def quiet_propagation():
    """DTensor's sharding propagation runs each operator once more on fake
    tensors of the GLOBAL shapes (under the active fake mode, if any).
    Inside this context it runs with every mode suspended, so the meters see
    only the operators a rank runs on its shards."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def quiet(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _meter_class():
    """``CommDebugMode`` that also sums each collective's result bytes (its
    import waits for the first trace)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._pytree import tree_leaves

    class CollectiveMeter(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.bytes = dict.fromkeys(COLLECTIVES, 0)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            kind = None if out is NotImplemented else _collective_kind(func)
            if kind is not None:
                self.bytes[kind] += sum(t.numel() * t.element_size()
                                        for t in tree_leaves(out)
                                        if isinstance(t, torch.Tensor))
            return out

        def record(self) -> Dict[str, Any]:
            counts = dict.fromkeys(COLLECTIVES, 0)
            for op, n in self.get_comm_counts().items():
                kind = _collective_kind(op)
                if kind is not None:
                    counts[kind] += n
            return {**self.bytes, "counts": counts}

    return CollectiveMeter


def collective_bytes(fn: Callable[[], Any]) -> Dict[str, Any]:
    """Run ``fn()`` and return its collectives: bytes per type and
    ``counts`` per type (the reference's ``collective_bytes`` record)."""
    with _meter_class()() as meter:
        fn()
    return meter.record()


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def cell_key(arch_id: str, shape_name: str, multi_pod: bool, variant: str) -> str:
    return f"{arch_id}|{shape_name}|{mesh_name(multi_pod)}|{variant}"


def apply_variant(cfg, variant: str):
    """The reference's perf variants of a configuration."""
    if variant in ("base", "fsdp", "ddp", "accum4", "accum8"):
        return cfg
    if variant == "exact":  # the paper's ablation: exact transcendentals
        from repro_torch.approx import ApproxConfig

        return cfg.replace(approx=ApproxConfig(mode="exact"))
    if variant == "no_remat":
        return cfg.replace(remat=False)
    if variant == "cf10":  # MoE capacity factor 1.0
        return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    if variant == "limit4":  # device-limited routing: <= 4 of 16 EP destinations
        return cfg.replace(moe=dataclasses.replace(
            cfg.moe, device_groups=16, max_groups=4, capacity_factor=1.0))
    raise KeyError(variant)


def variant_rules(mesh, variant: str) -> Dict[str, Any]:
    """The logical rules of a variant: ``fsdp`` and ``ddp`` lay the batch
    over the whole mesh and shard no activation over 'model'."""
    rules = default_rules(mesh)
    if variant in ("fsdp", "ddp"):
        rules = {**rules, "batch": tuple(axis_names(mesh)), "model": None,
                 "expert": None, "vocab": None, "heads": None, "ff": None}
    return rules


def batch_axes(rules, mesh, batch_size: int):
    """The batch dim's mesh axes, or None when the batch does not divide
    them (``long_500k``'s single sequence stays replicated)."""
    return divisible_axes(rules.get("batch"), mesh, batch_size)


def auto_accum(shape, mesh, rules, variant: str) -> int:
    """The reference's accumulation (``accumN`` variants, else a micro-batch
    of ~4k tokens a data rank), capped at a divisor of the rows each rank
    holds."""
    dsize = int(np.prod([s for n, s in axis_sizes(mesh).items() if n != "model"]))
    a = max(1, int(shape.global_batch * shape.seq_len / max(1, dsize) // 4096))
    while a > 1 and shape.global_batch % a:
        a -= 1
    a = max(1, {"accum1": 1, "accum4": 4, "accum8": 8}.get(variant, a))
    bax = batch_axes(rules, mesh, shape.global_batch)
    rows = shape.global_batch // axes_size(bax, mesh)
    while rows % a:
        a -= 1
    return a


@dataclass
class Cell:
    """A placed cell: the step and its arguments (trees of DTensors and plain
    tensors), ready to run under ``use_sharding(mesh, rules)``."""

    kind: str
    mesh: Any
    rules: Dict[str, Any]
    args: tuple
    step: Callable
    accum: int = 1

    def run(self):
        with use_sharding(self.mesh, self.rules):
            return self.step(*self.args)


def place(t: torch.Tensor, mesh, placements):
    """``distribute(t, mesh, placements)``: this rank's shard of the whole
    tensor ``t``.  A tensor without data (fake or ``meta``) gets an empty
    shard of the same shape, made in one operator."""
    from torch._subclasses.fake_tensor import is_fake, unset_fake_temporarily

    if t.device.type != "meta" and not is_fake(t):
        return distribute(t, mesh, placements)
    from torch.distributed.tensor import DTensor

    with unset_fake_temporarily():  # plain arithmetic on the mesh's coordinates
        shape = _local_shape(tuple(t.shape), mesh, tuple(placements))
    return DTensor.from_local(torch.empty(shape, dtype=t.dtype, device=t.device), mesh,
                              placements, run_check=False, shape=t.shape,
                              stride=t.stride())


@functools.lru_cache(maxsize=4096)
def _local_shape(shape, mesh, placements):
    """This rank's shard shape of a ``shape`` tensor placed on ``mesh`` (a
    stack's layers repeat a few shapes)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return compute_local_shape_and_global_offset(shape, mesh, placements)[0]


def _lay(tree, mesh, placements):
    return tree_map(lambda t, pl: place(t, mesh, pl), tree, placements)


def place_batch(batch, mesh, bax):
    """The inputs ``batch`` (whole) with dim 0 over the mesh axes ``bax``
    (None: replicated); a 0-d entry (decode's position) stays plain."""
    pl = lambda t: to_placements(P(bax, *([None] * (t.dim() - 1))), mesh)
    return {k: place(v, mesh, pl(v)) if v.dim() else v for k, v in batch.items()}


def place_cell(model, shape, mesh, variant: str, params, batch, cache=None,
               accum: Optional[int] = None) -> Cell:
    """The cell's step over ``mesh`` with its arguments placed as the
    reference places them (module docstring).  ``params`` is the whole f32
    parameter tree, ``batch`` the whole inputs (``input_specs``' entries),
    ``cache`` the whole cache of a serving cell; each is cut to this rank's
    shards without traffic.  ``accum`` defaults to :func:`auto_accum`."""
    rules = variant_rules(mesh, variant)
    if variant == "fsdp":
        pspecs = fsdp_pspecs(params, mesh)
    elif variant == "ddp":
        pspecs = _nest({path: P() for path in stacked_view(params)})
    else:
        pspecs = param_pspecs(params, mesh, rules)
    pl = shardings_from_specs(mesh, pspecs, params)
    placed_batch = place_batch(batch, mesh, batch_axes(rules, mesh, shape.global_batch))
    if shape.kind == "train":
        accum = accum or auto_accum(shape, mesh, rules, variant)
        opt = adamw.AdamWConfig()
        if variant in ("fsdp", "ddp"):
            master_pl = moment_pl = pl
            step = make_train_step(model, opt, accum=accum)
        else:  # WUS: the f32 master in the ZeRO-1 layout, a bf16 TP work copy a step
            master_pl = moment_pl = shardings_from_specs(
                mesh, zero1_pspecs(params, mesh, rules), params)
            step = make_train_step(model, opt, accum=accum, work_shardings=pl,
                                   master_shardings=master_pl)
        if variant == "ddp":  # the moments ZeRO-1 over the flat mesh
            moment_pl = shardings_from_specs(mesh, zero1_pspecs(
                params, mesh, {**rules, "batch": tuple(axis_names(mesh))}), params)
        zeros = lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
        count = lambda: torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
        state = {"params": _lay(tree_map(lambda t: t.to(torch.float32), params), mesh,
                                master_pl),
                 "opt": {"m": _lay(tree_map(zeros, params), mesh, moment_pl),
                         "v": _lay(tree_map(zeros, params), mesh, moment_pl),
                         "count": count()},
                 "step": count()}
        return Cell("train", mesh, rules, (state, placed_batch), step, accum)
    # serving reads bf16 params (the deployment norm; half the weight traffic)
    work = _lay(tree_map(lambda t: t.to(torch.bfloat16), params), mesh, pl)
    cspecs = cache_pspecs(cache, mesh, rules)
    placed_cache = {k: place(v, mesh, to_placements(cspecs[k], mesh))
                    for k, v in cache.items()}
    if shape.kind == "prefill":
        return Cell("prefill", mesh, rules, (work, placed_batch, placed_cache),
                    model.prefill)
    return Cell("decode", mesh, rules,
                (work, placed_batch["tok"], placed_batch["pos"], placed_cache),
                model.decode_step)


def local_bytes(*trees) -> int:
    """Bytes this rank holds of every tensor in ``trees`` (a DTensor's
    local shard)."""
    total = 0
    for tree in trees:
        for t in leaves(tree):
            t = t.to_local() if is_dtensor(t) else t
            total += t.numel() * t.element_size()
    return total


def _local_tensors(trees):
    return [t.to_local() if is_dtensor(t) else t for tree in trees for t in leaves(tree)]


def trace_cell(cell: Cell) -> Dict[str, Any]:
    """Run the placed cell's step once under the meters (inside the fake
    tensor mode the cell was placed in) and return its per-device memory,
    FLOPs and collectives."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    args = local_bytes(*cell.args)
    mt = MemTracker()
    mt.track_external(*_local_tensors(cell.args))
    flops = FlopCounterMode(display=False)
    meter = _meter_class()()
    t0 = time.perf_counter()
    with quiet_propagation(), mt, flops, meter:
        cell.run()
    seconds = time.perf_counter() - t0
    peak = max(d["Total"] for d in mt.get_tracker_snapshot("peak").values())
    return {"memory": {"argument_size_in_bytes": args, "peak_size_in_bytes": peak,
                       "temp_size_in_bytes": peak - args},
            "flops_per_device": int(flops.get_total_flops()),
            "collectives": meter.record(), "compile_s": seconds, "accum": cell.accum}


_ABSTRACT = weakref.WeakKeyDictionary()


def abstract_params(model):
    """``model.abstract_params()``, made once a model."""
    if model not in _ABSTRACT:
        _ABSTRACT[model] = model.abstract_params()
    return _ABSTRACT[model]


def fake_arguments(model, shape, device):
    """Whole fake parameter tree, inputs and (serving) cache of ``shape``,
    made inside the active ``FakeTensorMode``."""
    fake = lambda t: torch.empty(t.shape, dtype=t.dtype, device=device)
    params = tree_map(fake, abstract_params(model))
    batch = tree_map(fake, input_specs(model.cfg, shape))
    cache = None
    if shape.kind != "train":
        cache = model.init_cache(shape.global_batch, shape.seq_len, device=device)
    return params, batch, cache


def trace_once(model, shape, mesh, variant: str = "base", device="cpu",
               accum: Optional[int] = None) -> Dict[str, Any]:
    """:func:`trace_cell` of ``model``'s whole ``shape`` cell on ``mesh``
    under a fresh ``FakeTensorMode`` (fake ``device`` tensors; the model's
    own tables, real, enter as constants)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        params, batch, cache = fake_arguments(model, shape, device)
        cell = place_cell(model, shape, mesh, variant, params, batch, cache, accum)
        del params, batch, cache
        return trace_cell(cell)


def argument_bytes(model, shape, mesh, variant: str = "base") -> Dict[str, int]:
    """The cell's per-device argument bytes, from its arguments placed on
    ``meta`` (no trace): ``{"total", "batch"}``."""
    batch = input_specs(model.cfg, shape)
    cache = (None if shape.kind == "train"
             else model.abstract_cache(shape.global_batch, shape.seq_len))
    cell = place_cell(model, shape, mesh, variant, abstract_params(model), batch, cache,
                      accum=1)
    bax = batch_axes(cell.rules, mesh, shape.global_batch)
    return {"total": local_bytes(*cell.args), "batch": local_bytes(place_batch(batch, mesh, bax))}


def _extend(m1, m2, step: int, n: int):
    """A measure taken at depths d and d + ``step`` layers (``m1``, ``m2``)
    carried linearly ``n`` layers past d + ``step``."""
    if isinstance(m1, dict):
        return {k: _extend(m1[k], m2[k], step, n) for k in m1}
    return m2 + (m2 - m1) * n // step


def _affine(a, b, ca: int, cb: int):
    """``ca * a + cb * b``, entry by entry."""
    if isinstance(a, dict):
        return {k: _affine(a[k], b[k], ca, cb) for k in a}
    return ca * a + cb * b


def _div(a, n: int):
    if isinstance(a, dict):
        return {k: _div(v, n) for k, v in a.items()}
    return a // n


def trace_on_mesh(model, shape, mesh, variant: str = "base", device="cpu",
                  accum: Optional[int] = None) -> Dict[str, Any]:
    """The cell's per-device memory, FLOPs and collectives.

    The step is traced at two cut depths one layer period apart (a period
    is one layer, or one local:global group: depths 2 and 3 layers serving,
    1 and 2 training, or 1 and 2 groups), with one micro-batch and, when
    the step accumulates, a = min(accum, 3), each micro-batch the cell's own
    size; the measures are then carried to the cell.  Every period of a
    stack is the same layers and every micro-batch the same work, so the
    FLOPs and the collectives are linear in the depth, the FLOPs are linear
    in the micro-batches, and the collectives split into a part each
    micro-batch repeats and a part the step does once.  The peak is carried
    linearly in the depth from the traces with a micro-batches (the peak is
    the same from the third micro-batch on: each adds its grads into the one
    accumulator), its batch's bytes replaced by the cell's.  (Every layer of
    a serving step writes its new k/v into one new cache allocated before
    the first, so no layer's peak outgrows another's.)  The argument bytes are the cell's
    own (:func:`argument_bytes`).  A stack no deeper than the second cut is
    traced whole."""
    cfg = model.cfg
    period = max(1, cfg.attn.global_every)
    # a serving step's first layer shares its peak with the embedding and
    # the head (the increments from depth 1 to 2 of stablelm's (1, 4096)
    # prefill and (1, 32768) decode differ from the later ones by 43% and
    # 19%), so a period-1 stack serves from depth 2; a training step's
    # increments are equal from depth 1 (stablelm, batch 8 x 128, accum 2)
    first = 2 if period == 1 and shape.kind != "train" else 1
    depths = (first * period, (first + 1) * period)
    if cfg.n_layers <= depths[1]:
        rec = trace_once(model, shape, mesh, variant, device, accum)
        rec["trace"] = {"depths": [cfg.n_layers], "micro_batches": [rec["accum"]]}
        return rec
    rules = variant_rules(mesh, variant)
    if shape.kind != "train":
        accum = 1
    accum = accum or auto_accum(shape, mesh, rules, variant)
    micros = (1, min(accum, 3)) if accum > 1 else (1,)
    sub = lambda a: (dataclasses.replace(shape, global_batch=a * shape.global_batch // accum)
                     if shape.kind == "train" else shape)
    runs = {}
    for d in depths:
        cut = build_model(cfg.replace(n_layers=d), device)
        for a in micros:
            runs[d, a] = trace_once(cut, sub(a), mesh, variant, device, a)
            runs[d, a]["batch"] = argument_bytes(cut, sub(a), mesh, variant)["batch"]
    n = cfg.n_layers - depths[1]
    at = lambda a, key: _extend(runs[depths[0], a][key], runs[depths[1], a][key], period, n)
    coll, a = at(1, "collectives"), micros[-1]
    if accum > 1:  # c(accum) = c(1) + (accum - 1) * per, per = (c(a) - c(1)) / (a - 1)
        per = _affine(at(a, "collectives"), coll, 1, -1)
        coll = _affine(coll, _div(per, a - 1), 1, accum - 1)
    args = argument_bytes(model, shape, mesh, variant)
    peak = at(a, "memory")["peak_size_in_bytes"] - runs[depths[1], a]["batch"] + args["batch"]
    return {"memory": {"argument_size_in_bytes": args["total"], "peak_size_in_bytes": peak,
                       "temp_size_in_bytes": peak - args["total"]},
            "flops_per_device": at(1, "flops_per_device") * accum,
            "collectives": coll, "accum": accum,
            "compile_s": sum(r["compile_s"] for r in runs.values()),
            "trace": {"depths": list(depths), "micro_batches": list(micros)}}


def moe_exchange(cfg, shape, mesh, variant: str, accum: int) -> Dict[str, Any]:
    """An MoE cell's dispatch exchange (``models.mlp.moe_on_mesh``), by the
    layout's arithmetic: a micro-batch's global capacity C, C_pad, the rows
    each rank computes of each of its E_loc experts, the E_col experts of
    its column, and the bytes one layer's buffer moves a traversal (the
    reduce-scatter's input, the all-gather's result: E_col x C_pad x d_model
    bf16 a micro-batch, over the step's micro-batches) beside the cost
    model's ``a2a_v`` (``cost_model.moe_a2a_bytes``), which it equals where
    n_data = n_model."""
    from repro_torch.analysis.cost_model import moe_a2a_bytes
    from repro_torch.models.mlp import moe_capacity
    from repro_torch.parallel.sharding import ExpertLayout

    rules = variant_rules(mesh, variant)
    bax = batch_axes(rules, mesh, shape.global_batch)
    bax = () if bax is None else bax if isinstance(bax, tuple) else (bax,)
    names = axis_names(mesh)
    E = cfg.moe.n_experts
    S = shape.seq_len if shape.kind != "decode" else 1
    C = moe_capacity(shape.global_batch // accum * S, cfg.moe.top_k, E,
                     cfg.moe.capacity_factor)
    lay = ExpertLayout(mesh, (i for i, n in enumerate(names) if n in bax), E, C, rules)
    b_dev = shape.global_batch / axes_size(bax or None, mesh)
    return {"capacity": C, "c_pad": lay.c_pad, "rows": lay.c_pad // lay.n_rows,
            "e_loc": lay.e_loc, "e_col": lay.e_col,
            "exchange_bytes": lay.e_col * lay.c_pad * cfg.d_model * 2 * accum,
            "a2a_v": moe_a2a_bytes(cfg, b_dev, S,
                                   variant if shape.kind == "train" else "base")}


def not_ported(cfg, variant: str) -> Optional[str]:
    """Why a cell cannot run on a mesh yet, or None."""
    if cfg.family not in MESH_FAMILIES:
        return f"the {cfg.family} family on a mesh is not ported: {NOT_PORTED}"
    return None


def run_cell(arch_id: str, shape_name: str, multi_pod: bool, variant: str = "base",
             device="cpu") -> Dict[str, Any]:
    """Trace one cell on the production mesh over a fake world (256 or 512
    ranks); the world is taken down after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_fake_process_group, make_production_mesh

    cfg = get_config(arch_id)
    shape = {s.name: s for s in shapes_for(cfg)}.get(shape_name)
    if shape is None:
        return {"status": "skipped",
                "reason": f"{shape_name} not applicable to {arch_id}"}
    why = not_ported(cfg, variant)
    if why:
        return {"status": "not_ported", "reason": why}
    cfg = apply_variant(cfg, variant)
    init_fake_process_group(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        model = build_model(cfg, device)
        rec = trace_on_mesh(model, shape, mesh, variant, device)
        if cfg.family == "moe":
            rec["moe_exchange"] = moe_exchange(cfg, shape, mesh, variant, rec["accum"])
    finally:
        dist.destroy_process_group()
    return {"status": "ok", **rec, "compile_s": round(rec["compile_s"], 1),
            "n_chips": 512 if multi_pod else 256, "mesh": mesh_name(multi_pod),
            "params": int(cfg.param_count()), "active_params": int(cfg.active_param_count()),
            "tokens": int(shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                                else 1)),
            "kind": shape.kind, "variant": variant, "device": str(device)}


def load_results(path: str = RESULTS_PATH) -> Dict[str, Any]:
    path = os.path.abspath(path)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(results: Dict[str, Any], path: str = RESULTS_PATH) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"  # one a process: sweeps may run side by side
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multipod", "both"])
    ap.add_argument("--variant", default="base")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_PATH,
                    help="the results file (default build/dryrun_torch.json)")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"],
                    help="the fake tensors' device (nothing is allocated on it; "
                         "cuda needs a CUDA build of PyTorch)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch in (None, "all")) else [args.arch]
    meshes = {"single": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    results = load_results(args.out)
    for arch_id in archs:
        shapes = [s.name for s in shapes_for(get_config(arch_id))]
        if args.shape and args.shape != "all":
            shapes = [args.shape]
        for shape_name in shapes:
            for mp in meshes:
                key = cell_key(arch_id, shape_name, mp, args.variant)
                if results.get(key, {}).get("status") == "ok" and not args.force:
                    print(f"[cached] {key}")
                    continue
                print(f"[run] {key} ...", flush=True)
                try:
                    rec = run_cell(arch_id, shape_name, mp, args.variant, args.device)
                except Exception as e:  # recorded: a failure is a fault to fix
                    rec = {"status": "error", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                # merge-fresh before save: concurrent sweeps must not clobber
                results = load_results(args.out)
                results[key] = rec
                save_results(results, args.out)
                print(f"   -> {rec.get('status')} ({rec.get('compile_s', '-')}s, "
                      f"flops/dev={rec.get('flops_per_device', '-')})", flush=True)
    return results


if __name__ == "__main__":
    main()
