"""Training loop: the train step with gradient accumulation, checkpoint and
restart, preemption handling, straggler monitoring — the JAX package's
``train/loop.py`` on PyTorch, for one card.

Fault-tolerance contract (the reference's):
  * checkpoints every ``ckpt_every`` steps (async, atomic, keep-K);
  * SIGTERM/SIGINT => stop at the next step boundary, final checkpoint,
    clean exit;
  * restart: ``run()`` restores the latest checkpoint and resumes the exact
    data stream (the pipeline is counter-addressed by step — no state to
    replay);
  * unexpected exception => emergency checkpoint attempt, then re-raise;
  * straggler monitor: per-step wall times, warn on > straggler_factor x
    median.

On a mesh a checkpoint gathers every DTensor (a collective), so the ranks
save together or not at all: at each step boundary they agree (one
all-reduce) on the stop flag and on whether a rank failed to make its
batch; then every rank stops at the same step, or saves the emergency
checkpoint and raises together.  An exception inside a step on one rank
leaves the others in a collective of that step: that rank re-raises at
once with no emergency checkpoint (the restart point is the last periodic
one), and the others fail when its process exits (``torchrun`` ends the
job) or at the process group's timeout.

PyTorch runs eagerly: there is no jit, and the step updates the state in
place (:func:`repro_torch.optim.adamw.update`).  An exception inside that
update leaves the state partly updated, and the emergency checkpoint then
holds it as it is.

``run(mesh=...)`` trains over a ``DeviceMesh`` (``launch.mesh``) with
weight-update sharding (WUS) and ZeRO-1, as the reference does: the f32
master and the AdamW moments are DTensors in the ZeRO-1 layout
(``parallel.params.zero1_pspecs``, spread over the whole mesh); each step
casts the master ONCE to a bf16 work copy in the tensor-parallel layout
(``param_pspecs``), runs the model under ``use_sharding(mesh)`` against it,
and reshards each micro-batch's bf16 grads into the master layout before the
f32 cast.  This slice trains the dense family there in ``table_pack``,
``sharded_pack`` and ``sharded_pack_ref``; the other modes and families on
a mesh wait for ROADMAP queue 1, item 12c.
"""

from __future__ import annotations

import os
import signal
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.data.pipeline import SyntheticLM, data_config_for
from repro_torch.kernels import _build
from repro_torch.optim import adamw
from repro_torch.parallel.params import (param_pspecs, shardings_from_specs,
                                         zero1_pspecs)
from repro_torch.parallel.sharding import P, distribute, use_sharding
from repro_torch.tree import leaves, tree_map, unflatten

from .checkpoint import CheckpointManager


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_keep: int = 3
    accum: int = 1  # gradient-accumulation microbatches
    zero1: bool = True  # on a mesh: shard optimizer moments over the data axis too
    log_every: int = 10
    straggler_factor: float = 1.5
    opt: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)


class StragglerMonitor:
    def __init__(self, factor: float = 1.5, window: int = 50):
        self.factor = factor
        self.times: list[float] = []
        self.window = window
        self.flagged = 0

    def record(self, dt: float) -> Optional[str]:
        self.times.append(dt)
        self.times = self.times[-self.window:]
        if len(self.times) >= 10:
            med = float(np.median(self.times))
            if dt > self.factor * med:
                self.flagged += 1
                return (f"straggler step: {dt * 1e3:.1f}ms vs median "
                        f"{med * 1e3:.1f}ms (x{dt / med:.2f})")
        return None


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch -> tensors on ``device``: the integer token arrays as
    int64, the floating ones (an encoder-decoder's ``frames``, a VLM's
    ``patches``) as f32."""
    def put(v):
        v = np.asarray(v)
        dt = torch.float32 if np.issubdtype(v.dtype, np.floating) else torch.int64
        return torch.from_numpy(v).to(device=device, dtype=dt)
    return {k: put(v) for k, v in batch.items()}


def value_and_grad(model, params, batch):
    """``(loss, grads)`` of ``model.loss`` at ``params``: the loss detached,
    the grads f32 tensors in ``params``' tree structure."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), unflatten(params, list(grads))


def accumulated_grads(model, params, batch, accum: int = 1):
    """``(loss, grads)`` over ``batch`` split into ``accum`` microbatches
    along the batch axis.  Each microbatch's GRADS (not its loss) are scaled
    by ``1/accum`` before they are added, in an unrolled loop: the accum=1 and
    accum=N paths share the per-micro arithmetic, and only one microbatch's
    activations and grads are alive at a time besides the accumulator."""
    if accum == 1:
        return value_and_grad(model, params, batch)
    micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
             for k, v in batch.items()}
    inv = 1.0 / accum
    loss = torch.zeros((), dtype=torch.float32, device=model.device)
    acc = None
    for a in range(accum):
        l, g = value_and_grad(model, params, {k: v[a] for k, v in micro.items()})
        loss = loss + l * inv
        g = [t.mul_(inv) for t in leaves(g)]
        if acc is None:  # 0 + g * inv, without the zeros
            acc = g
        else:
            for s, t in zip(acc, g):
                s.add_(t)
        del g
    return loss, unflatten(params, acc)


def make_train_step(model, opt_cfg: adamw.AdamWConfig, accum: int = 1,
                    work_shardings=None, master_shardings=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; state =
    ``{"params", "opt", "step"}``, updated in place and returned.  The grads
    come from :func:`accumulated_grads`.

    Weight-update sharding (``work_shardings`` + ``master_shardings``, trees
    of DTensor placements in the parameters' structure): ``state["params"]``
    is the f32 master in the master layout; the step casts it ONCE to a
    bf16 work copy redistributed to the work (tensor-parallel) layout, takes
    each micro-batch's grads against the work copy, and reshards them into
    the master layout FIRST (bf16 on the wire) and casts to f32 after, on
    the small master shard; each is scaled by 1/accum and added there."""
    wus = work_shardings is not None

    @torch.no_grad()
    def _work(params):
        return tree_map(lambda p, pl: p.to(torch.bfloat16).redistribute(
            p.device_mesh, pl), params, work_shardings)

    def _to_master(grads):
        return tree_map(lambda g, pl: g.redistribute(g.device_mesh, pl).to(torch.float32),
                        grads, master_shardings)

    def wus_grads(params, batch):
        pw = _work(params)
        if accum == 1:
            loss, gw = value_and_grad(model, pw, batch)
            return loss, _to_master(gw)
        micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                 for k, v in batch.items()}
        inv = 1.0 / accum
        loss, acc = 0.0, None
        for a in range(accum):
            l, gw = value_and_grad(model, pw, {k: v[a] for k, v in micro.items()})
            gm = [g * inv for g in leaves(_to_master(gw))]
            del gw
            loss = loss + l * inv
            acc = gm if acc is None else [s + g for s, g in zip(acc, gm)]
        return loss, unflatten(params, acc)

    def train_step(state, batch):
        params = state["params"]
        if wus:
            loss, grads = wus_grads(params, batch)
        else:
            loss, grads = accumulated_grads(model, params, batch, accum)
        params, opt, metrics = adamw.update(opt_cfg, params, grads, state["opt"])
        metrics["loss"] = loss
        return {"params": params, "opt": opt, "step": state["step"] + 1}, metrics

    return train_step


def init_state(model) -> Dict[str, Any]:
    """Fresh train state: random parameters from seed 0 on the model's
    device (the reference's ``jax.random.key(0)``), zero AdamW moments,
    step 0."""
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    return {"params": params, "opt": adamw.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


# what this slice trains over a mesh (ROADMAP queue 1, item 12c: the rest)
MESH_MODES = ("table_pack", "sharded_pack", "sharded_pack_ref")
MESH_FAMILIES = ("dense",)


def check_mesh_training(model) -> None:
    """Raise unless ``model`` trains over a mesh in this slice."""
    mode, family = model.cfg.approx.mode, model.cfg.family
    if mode not in MESH_MODES or family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"training {family!r} in approx mode {mode!r} over a mesh is not "
            f"ported (this slice: the {'/'.join(MESH_FAMILIES)} family in "
            f"{', '.join(MESH_MODES)}): ROADMAP queue 1, item 12c")


def state_pspecs(model, mesh, zero1: bool = True, wus: bool = True):
    """Partition specs (the reference's layout) of the train state:
    ``wus=True`` stores the params as the f32 master in the fully-2D ZeRO-1
    layout, the same as the moments; the TP work layout exists only inside
    the step."""
    abstract = model.abstract_params()
    pspec = param_pspecs(abstract, mesh)
    mspec = zero1_pspecs(abstract, mesh) if zero1 else pspec
    return {"params": mspec if wus else pspec,
            "opt": {"m": mspec, "v": mspec, "count": P()},
            "step": P()}


def work_pspecs(model, mesh):
    """The TP work layout used inside the step (see make_train_step WUS)."""
    return param_pspecs(model.abstract_params(), mesh)


def state_placements(model, mesh, zero1: bool = True):
    """DTensor placements of the train state's tensors (the state's
    structure).  The counters (``P()`` in the specs) stay plain tensors, the
    same on every rank: None."""
    like = model.abstract_params()
    specs = state_pspecs(model, mesh, zero1)
    master = shardings_from_specs(mesh, specs["params"], like)
    return {"params": master, "opt": {"m": master, "v": master, "count": None},
            "step": None}


def distribute_state(state, placements, mesh):
    """The whole train state (the same on every rank) laid out with
    ``placements`` (:func:`state_placements`); the counters stay plain."""
    lay = lambda tree, pl: tree_map(lambda t, p: distribute(t, mesh, p), tree, pl)
    opt = state["opt"]
    return {"params": lay(state["params"], placements["params"]),
            "opt": {"m": lay(opt["m"], placements["opt"]["m"]),
                    "v": lay(opt["v"], placements["opt"]["v"]), "count": opt["count"]},
            "step": state["step"]}


def _batch_on(batch, mesh):
    """The whole batch as replicated DTensors (the reference's unsharded
    batch input: the model's ``shard`` annotations lay it out)."""
    from torch.distributed.tensor import Replicate

    return {k: distribute(v, mesh, [Replicate()] * mesh.ndim) for k, v in batch.items()}


def _agree(mesh, *flags: bool) -> list:
    """Each flag OR-ed over every rank of ``mesh`` (an all-reduce MAX on each
    mesh dim in turn), read on the host."""
    import torch.distributed as dist

    t = torch.tensor([int(f) for f in flags], dtype=torch.int32,
                     device=mesh.device_type)
    for d in range(mesh.ndim):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(d))
    return [bool(v) for v in t.tolist()]


class PeerFailed(RuntimeError):
    """Another rank of the mesh failed before this step."""


def run(model, shape, cfg: TrainConfig, mesh=None,
        log: Callable[[str], None] = print) -> Dict[str, Any]:
    """End-to-end training with restart.  Returns the final metrics summary;
    ``build_time_s`` is the wall time of the steps during which a CUDA kernel
    was built (nvcc), the port's counterpart of the reference's compile
    time.  ``mesh``: train over it (module docstring); every rank runs
    ``run`` and rank 0 writes the checkpoints."""
    data = SyntheticLM(data_config_for(model.cfg, shape))
    ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep)
    placements = None
    if mesh is not None:
        check_mesh_training(model)
        like = model.abstract_params()
        placements = state_placements(model, mesh, cfg.zero1)
        train_step = make_train_step(
            model, cfg.opt, cfg.accum,
            work_shardings=shardings_from_specs(mesh, work_pspecs(model, mesh), like),
            master_shardings=placements["params"])
    else:
        train_step = make_train_step(model, cfg.opt, cfg.accum)

    stop = {"flag": False, "reason": ""}

    def _handler(signum, frame):
        stop["flag"] = True
        stop["reason"] = f"signal {signum}"

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, _handler)
        except ValueError:  # non-main thread (tests)
            pass

    state = init_state(model)
    if mesh is not None:
        state = distribute_state(state, placements, mesh)
    step0, restored = ckpt.restore_latest(state, placements, mesh)
    if restored is None:
        step0 = 0
        log("initialized fresh state")
    else:
        state = restored
        log(f"restored checkpoint at step {step0}")

    monitor = StragglerMonitor(cfg.straggler_factor)
    losses = []
    step = int(step0)
    build_time_s = 0.0
    rec = obs.enabled()
    tracer = obs.get_tracer() if rec else None
    step_hist = obs.get_registry().histogram("train.step_s") if rec else None
    agreed = False  # every rank knows of the fault: they save together
    try:
        while step < cfg.steps:
            fault = None
            try:
                batch = batch_to(data.batch_at(step), model.device)
            except Exception as e:
                fault = e
            halt = stop["flag"]
            if mesh is not None:
                halt, fault_any = _agree(mesh, halt, fault is not None)
                if fault_any:
                    agreed = True
                    raise fault or PeerFailed(f"another rank failed before step {step}")
            elif fault is not None:
                raise fault
            if halt:
                stop["flag"] = True
                stop["reason"] = stop["reason"] or "another rank was signalled"
                break
            if mesh is not None:
                batch = _batch_on(batch, mesh)
            if rec:
                tracer.begin("train.step", "train", step=step)
            built_before = _build.build_seconds()
            t0 = time.perf_counter()
            with use_sharding(mesh):
                state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])  # waits for the device
            dt = time.perf_counter() - t0
            built = _build.build_seconds() > built_before
            if built:
                build_time_s += dt
            if rec:
                if built:
                    tracer.instant("kernel.build", "build", phase="train.step")
                tracer.end("train.step", "train", **({"compiled": True} if built else {}))
                step_hist.observe(dt)
            warn = monitor.record(dt)
            if warn:
                log(f"[straggler] {warn}")
            step += 1
            losses.append(loss)
            if step % cfg.log_every == 0:
                log(f"step {step}: loss={losses[-1]:.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"lr={float(metrics['lr']):.2e} ({dt * 1e3:.0f}ms)")
            if step % cfg.ckpt_every == 0:
                with obs.span("train.ckpt", "train", step=step):
                    ckpt.save_async(step, state, extra={"loss": losses[-1]})
    except BaseException:
        if mesh is not None and not agreed:
            log("exception on one rank of the mesh — no emergency checkpoint "
                "(its gather needs every rank)")
            raise
        log("exception — attempting emergency checkpoint")
        ckpt.wait()
        ckpt.save(step, state, extra={"emergency": True})
        raise
    finally:
        for sig, h in old_handlers.items():
            signal.signal(sig, h)

    ckpt.wait()
    with obs.span("train.ckpt", "train", step=step, final=True):
        ckpt.save(step, state, extra={"final": True, "reason": stop["reason"]})
    return {"final_step": step, "losses": losses,
            "preempted": stop["flag"], "stragglers": monitor.flagged,
            "build_time_s": build_time_s}
