"""A pool of CPU ranks for the port's mesh tests (tests/test_torch_mesh.py).

``Pool(world, store)`` spawns ``world`` processes joined in one gloo process
group (rendezvous through a ``FileStore`` file, never a fixed port); each
waits for a task, runs it and sends back what it returns.  A task is a
function of this module (``TASKS``) that every rank runs with the same
arguments, building whatever ``DeviceMesh`` it needs over the world.  The
children import the port only (``repro_torch``): the reference's oracles are
computed in the test process and compared there.  Each child runs one intra-op
thread, within the per-worker share that tests/test_torch_threads.py sets.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import traceback

import numpy as np

TASKS = {}


def task(fn):
    TASKS[fn.__name__] = fn
    return fn


def _serve(rank, world, store, inbox, outbox):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    # DTensor warns when a redistribution takes one all-reduce a mesh dim
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    while True:
        msg = inbox.get()
        if msg is None:
            break
        name, kw = msg
        try:
            outbox.put((rank, True, TASKS[name](**kw)))
        except BaseException:  # the test process reports it
            outbox.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class Pool:
    def __init__(self, world: int, store: str):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world = world
        self.outbox = ctx.Queue()
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.procs = [ctx.Process(target=_serve, args=(r, world, store, q, self.outbox),
                                  daemon=True) for r, q in enumerate(self.inboxes)]
        for p in self.procs:
            p.start()

    def run(self, name: str, timeout: float = 240.0, **kw):
        """Every rank's result of task ``name``, in rank order; a rank that
        raised fails the call with its traceback."""
        for q in self.inboxes:
            q.put((name, kw))
        got = {}
        try:
            while len(got) < self.world:
                rank, ok, out = self.outbox.get(timeout=timeout)
                if not ok:
                    raise RuntimeError(f"rank {rank} failed {name}:\n{out}")
                got[rank] = out
        except queue.Empty:
            raise RuntimeError(f"{name}: ranks {sorted(set(range(self.world)) - set(got))} "
                               f"gave no answer in {timeout} s") from None
        return [got[r] for r in range(self.world)]

    def close(self):
        for q in self.inboxes:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()


# --------------------------------------------------------------------------------------
# tasks (run on every rank)
# --------------------------------------------------------------------------------------


def _layout(t) -> tuple:
    """A DTensor's placements as short names ('S<dim>', 'R', 'P')."""
    return tuple(f"S{p.dim}" if p.is_shard() else "R" if p.is_replicate() else "P"
                 for p in t.placements)


def _mesh(shape):
    """A CPU mesh of ``shape``: ('data', 'model'), or ('pod', 'data',
    'model') for three dims."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    names = ("pod", "data", "model")[-len(shape):]
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names)


@task
def pack_on_mesh(shape, e_a, omega, xs):
    """Place the sharded pack (``pack_shards`` = the 'model' width) and
    evaluate every member of ``xs`` ({name: f32 array}) on the mesh: value
    and slope, extrapolation off and on, f32 and bf16 (as f32 arrays), plus
    the value of a DTensor input sharded over 'data' and the closure's value
    and gradient.  Returns the results and what the rank holds."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.approx import ApproxConfig, table_pack
    from repro_torch.kernels import table_pack_lookup as K
    from repro_torch.parallel.sharding import distribute, local_rank, use_sharding

    mesh = _mesh(shape)
    width = shape[1]
    cfg = ApproxConfig(mode="sharded_pack", e_a=e_a, omega=omega, pack_shards=width)
    whole = cfg.sharded_pack("cpu")
    cfg.place_packs(mesh)
    pack = cfg.sharded_pack("cpu", mesh)
    with use_sharding(mesh):
        bound = cfg.sharded_pack("cpu")
    calls = []
    contrib = K.sharded_shard_contrib

    def counted(p, fn, shard, x, **kw):
        calls.append(shard)
        return contrib(p, fn, shard, x, **kw)

    K.sharded_shard_contrib = counted
    try:
        out = {}
        for name, x in xs.items():
            for dtype in (torch.float32, torch.bfloat16):
                xt = torch.from_numpy(x).to(dtype)
                for ex in (False, True):
                    for slope in (False, True):
                        y = table_pack.eval_sharded_mesh(pack, name, xt, mesh, extrapolate=ex,
                                                         use_kernel=True, slope=slope)
                        assert y.dtype == dtype
                        out[name, str(dtype), ex, slope] = y.float().numpy()
            # a DTensor input, batch-sharded over 'data': the same values
            xd = distribute(torch.from_numpy(x[: len(x) // shape[0] * shape[0]]), mesh,
                            [Shard(0), Replicate()])
            yd = table_pack.eval_sharded_mesh(pack, name, xd, mesh, use_kernel=True)
            assert tuple(yd.placements) == (Shard(0), Replicate())
            out[name, "dtensor"] = yd.full_tensor().numpy()
        # the closure: value, and the slope under a gradient
        with use_sharding(mesh):
            f = cfg.unary("silu", "cpu")
        xs_ = torch.from_numpy(xs["silu"]).requires_grad_(True)
        y = f(xs_)
        (g,) = torch.autograd.grad(y.sum(), xs_)
        out["closure"] = (y.detach().numpy(), g.numpy())
    finally:
        K.sharded_shard_contrib = contrib
    return {"out": out, "shard": local_rank(mesh, "model"), "calls": sorted(set(calls)),
            "n_calls": len(calls),
            "held": {k: tuple(getattr(pack, k).shape) for k in
                     ("values", "local_base", "owned", "owner", "owner_base")},
            "whole_values": tuple(whole.values.shape), "image": pack.image,
            # the placed pack under the binding; off it, the whole one
            "bound_is_placed": bound is pack, "off_is_whole": cfg.sharded_pack("cpu") is whole,
            "owner_set": sorted(set(pack.owner.flatten().tolist())),
            "first_shard": pack.first_shard}


def _reduced_cfg(mode, shards, arch=None):
    """Reduced stablelm (d_model 64, d_ff 128, 4 heads), or ``arch``'s reduced
    config (the MoE ones: E 4, k 2), in ``mode`` at ``shards`` pack shards."""
    from repro_torch.models import reduced

    if arch is None:
        cfg = reduced("stablelm-3b").replace(d_model=64, d_ff=128, n_heads=4, n_kv_heads=4)
    else:
        cfg = reduced(arch)
    return cfg.replace(approx=dataclasses.replace(cfg.approx, mode=mode,
                                                  pack_shards=shards))


def _tensors(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree))  # a copy: steps update in place


@task
def train_on_mesh(shape, mode, shards, params, batch, lr, accum, arch=None,
                  compute_dtype=None):
    """Reduced stablelm (or ``arch``, computing in ``compute_dtype`` if
    given) on a ``shape`` mesh in ``mode`` with the given
    weights (the port's tree, numpy): the sharded loss under
    ``use_sharding``, then one WUS step (f32 master and moments in the
    ZeRO-1 layout, bf16 TP work copy, ``accum`` micro-batches), with the
    sharded pack's mesh contributions counted; then the port's unmeshed
    step (f32, off the mesh) on the same weights and batch.  Returns the
    losses, the first parameter leaf after the step, every leaf's grads and
    change (new - old) from both steps, and the counts."""
    import torch

    from repro_torch.kernels import table_pack_lookup as K
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel.params import param_pspecs, shardings_from_specs
    from repro_torch.parallel.sharding import distribute, use_sharding
    from repro_torch.train import loop as L
    from repro_torch.tree import leaves, tree_map, unflatten

    mesh = _mesh(shape)
    cfg = _reduced_cfg(mode, shards, arch)
    if compute_dtype is not None:
        cfg = cfg.replace(compute_dtype=compute_dtype)
    model = build_model(cfg, "cpu", mesh=mesh)
    batch = L.batch_to(batch, "cpu")
    counts = {"mesh": 0, "off": 0}
    saved = {n: getattr(K, n) for n in ("sharded_shard_contrib", "sharded_shard_contrib_plain",
                                        "sharded_pack_lookup", "sharded_pack_grad")}
    update = adamw.update
    grads = []

    def counting(name, key):
        def f(*a, **kw):
            counts[key] += 1
            return saved[name](*a, **kw)
        return f

    def capture(opt_cfg, p, g, st):  # the grads the step hands to AdamW
        grads.append(full(g))
        return update(opt_cfg, p, g, st)

    def full(tree):
        return [(t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy().copy()
                for t in leaves(tree)]

    K.sharded_shard_contrib = counting("sharded_shard_contrib", "mesh")
    K.sharded_shard_contrib_plain = counting("sharded_shard_contrib_plain", "mesh")
    K.sharded_pack_lookup = counting("sharded_pack_lookup", "off")
    K.sharded_pack_grad = counting("sharded_pack_grad", "off")
    adamw.update = capture
    try:
        like = model.abstract_params()
        pl = shardings_from_specs(mesh, param_pspecs(like, mesh), like)
        dp = tree_map(lambda t, p: distribute(t, mesh, p), _tensors(params), pl)
        with use_sharding(mesh):
            loss = float(model.loss(dp, L._batch_on(batch, mesh)))
        opt = adamw.AdamWConfig(lr=lr, warmup_steps=0, total_steps=10, clip_norm=0.0)
        placements = L.state_placements(model, mesh)

        def fresh():
            p = _tensors(params)
            return {"params": p, "opt": adamw.init(p),
                    "step": torch.zeros((), dtype=torch.int32)}

        state = L.distribute_state(fresh(), placements, mesh)
        step = L.make_train_step(
            model, opt, accum,
            work_shardings=shardings_from_specs(mesh, L.work_pspecs(model, mesh), like),
            master_shardings=placements["params"])
        before = full(state["params"])
        with use_sharding(mesh):
            state, metrics = step(state, L._batch_on(batch, mesh))
        first = leaves(state["params"])[0]
        layout = [_layout(t) for t in leaves(state["params"])]
        delta = [b - a for a, b in zip(before, full(state["params"]))]
        mesh_counts = dict(counts)
        # AdamW off the mesh on the grads the mesh step took
        p = _tensors(params)
        update(opt, p, unflatten(p, [torch.from_numpy(g) for g in grads[0]]), adamw.init(p))
        own_delta = [b - a for a, b in zip(before, full(p))]
        # the unmeshed port: built off the binding, so the whole pack
        off_model = build_model(cfg, "cpu")
        off = fresh()
        off_before = full(off["params"])
        off, off_metrics = L.make_train_step(off_model, opt, accum)(off, batch)
        off_delta = [b - a for a, b in zip(off_before, full(off["params"]))]
        return {"loss": loss, "step_loss": float(metrics["loss"]),
                "first": first.full_tensor().numpy(), "counts": mesh_counts,
                "master_local": tuple(first.to_local().shape), "layout": layout,
                "grads": grads[0], "off_grads": grads[1], "delta": delta,
                "off_delta": off_delta, "own_delta": own_delta, "grad_norm": float(metrics["grad_norm"]),
                "off_grad_norm": float(off_metrics["grad_norm"]),
                "off_step_loss": float(off_metrics["loss"])}
    finally:
        for n, f in saved.items():
            setattr(K, n, f)
        adamw.update = update


@task
def checkpoint_across_meshes(root, params):
    """A train state saved from a (2, 2) mesh (each rank into its own
    directory: only rank 0 may write) restores bitwise onto (4, 1) and off
    the mesh."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import loop as L
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.tree import leaves, tree_map

    rank = dist.get_rank()
    model = build_model(_reduced_cfg("table_pack", 2), "cpu")
    params = _tensors(params)
    opt = adamw.init(params)
    opt["m"] = tree_map(lambda t: t * 0.5 + 1.0, params)
    opt["v"] = tree_map(lambda t: t * t, params)
    state = {"params": params, "opt": opt, "step": torch.tensor(3, dtype=torch.int32)}
    m22 = _mesh((2, 2))
    placed = L.distribute_state(state, L.state_placements(model, m22), m22)
    mine = os.path.join(root, f"rank{rank}")
    CheckpointManager(mine, keep=2).save(3, placed)
    dist.barrier()
    written = {r: sorted(os.listdir(os.path.join(root, f"rank{r}")))
               for r in range(dist.get_world_size())}
    src = os.path.join(root, "rank0")
    m41 = _mesh((4, 1))
    like41 = L.distribute_state(tree_map(torch.zeros_like, state),
                                L.state_placements(model, m41), m41)
    step41, on41 = CheckpointManager(src).restore_latest(
        like41, L.state_placements(model, m41), m41)
    step0, off = CheckpointManager(src).restore_latest(tree_map(torch.zeros_like, state))
    want = [t.numpy() for t in leaves(state)]
    got41 = [t.full_tensor().numpy() if hasattr(t, "full_tensor") else t.numpy()
             for t in leaves(on41)]
    layouts41 = [_layout(t) for t in leaves(on41["params"])]
    return {"written": written, "steps": (step41, step0),
            "bitwise_41": all(np.array_equal(a, b) for a, b in zip(want, got41)),
            "bitwise_off": all(np.array_equal(a, b.numpy()) for a, b in
                               zip(want, leaves(off))),
            "layouts41": layouts41}


@task
def mesh_constructors():
    """``launch.mesh`` over the pool's world of 4: the debug and sharded-pack
    meshes, and the production meshes' errors naming the world they need."""
    from repro_torch.launch import mesh as M

    d = M.make_debug_mesh(2, 2, "cpu")
    p = M.make_sharded_pack_mesh(4, 1, "cpu")
    errors = {}
    for name, multi in (("prod", False), ("multipod", True)):
        try:
            M.make_production_mesh(multi_pod=multi, device="cpu")
        except ValueError as e:
            errors[name] = str(e)
    return {"debug": (tuple(d.shape), d.mesh_dim_names),
            "pack": (tuple(p.shape), p.mesh_dim_names),
            "prod_error": errors.get("prod", ""), "multipod_error": errors.get("multipod", "")}


@task
def serve_on_mesh(params):
    """Reduced stablelm in sharded_pack (2 shards) served by the continuous
    engine: off the mesh, then with ``mesh=`` on a (2, 2) mesh (the engine
    places the pack) and a model built over it (its gate on the mesh,
    replicated activations taken as the same on every rank).  Returns both
    runs' tokens, whether the engine placed the pack, and the mesh
    contributions counted."""
    from repro_torch.kernels import table_pack_lookup as K
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ContinuousEngine

    cfg = _reduced_cfg("sharded_pack", 2)
    params = _tensors(params)
    reqs = make_requests(cfg.vocab, 3, 4)
    plain = build_model(cfg, "cpu")
    off = ContinuousEngine(plain, params, 2, 64).serve(reqs)
    mesh = _mesh((2, 2))
    ContinuousEngine(plain, params, 2, 64, mesh=mesh)
    placed = (cfg.approx.sharded_pack("cpu", mesh).mesh is mesh
              and cfg.approx.sharded_pack("cpu").mesh is None)  # off the mesh: whole
    calls = []
    contrib = K.sharded_shard_contrib

    def counted(*a, **kw):
        calls.append(a[2])
        return contrib(*a, **kw)

    K.sharded_shard_contrib = counted
    try:
        on = ContinuousEngine(build_model(cfg, "cpu", mesh=mesh), params, 2, 64,
                              mesh=mesh).serve(reqs)
    finally:
        K.sharded_shard_contrib = contrib
    return {"off": [r.tokens.tolist() for r in off], "on": [r.tokens.tolist() for r in on],
            "placed": placed, "calls": sorted(set(calls)), "n_calls": len(calls)}


@task
def fault_on_one_rank(root, how):
    """``run(mesh=...)`` on a (2, 2) mesh, reduced stablelm in table_pack, 3
    steps; rank 1 alone fails to make its batch at step 1 (``how`` =
    "raise") or is signalled there (``how`` = "signal": SIGTERM to itself).
    Returns what the rank's run returned or raised, its seconds, and the
    checkpoints in ``root`` (every rank saves into it; rank 0 writes)."""
    import os
    import signal
    import time

    import torch.distributed as dist

    from repro_torch.data import pipeline
    from repro_torch.models import ShapeSpec, build_model
    from repro_torch.train import loop as L

    rank = dist.get_rank()
    mesh = _mesh((2, 2))
    model = build_model(_reduced_cfg("table_pack", 2), "cpu", mesh=mesh)
    batch_at = pipeline.SyntheticLM.batch_at

    def faulty(self, step):
        if rank == 1 and step == 1:
            if how == "raise":
                raise ValueError("injected batch fault")
            os.kill(os.getpid(), signal.SIGTERM)
        return batch_at(self, step)

    pipeline.SyntheticLM.batch_at = faulty
    cfg = L.TrainConfig(steps=3, ckpt_every=100, ckpt_dir=root)
    t0 = time.perf_counter()
    try:
        out = L.run(model, ShapeSpec("t", seq_len=8, global_batch=4, kind="train"), cfg,
                    mesh=mesh, log=lambda s: None)
        res = {"out": {k: out[k] for k in ("final_step", "preempted")}}
    except Exception as e:
        res = {"raised": f"{type(e).__name__}: {e}"}
    finally:
        pipeline.SyntheticLM.batch_at = batch_at
    res["seconds"] = time.perf_counter() - t0
    dist.barrier()
    res["ckpts"] = sorted(os.listdir(root)) if os.path.isdir(root) else []
    return res


@task
def serve_dtensor(params, prompts, refill, slot, steps, cache_len, compute_dtype, arch=None):
    """Reduced stablelm (or ``arch``; table_pack) serving with DTensor params and a
    DTensor cache on a (2, 2) mesh (``param_pspecs``, ``cache_pspecs``; the
    batch over 'data', the heads over 'model'): prefill ``prompts`` (B, S),
    ``steps`` greedy decode steps with per-slot (B,) positions, refill
    ``slot`` from a prefill of ``refill`` (its rows scattered into the cache
    off the mesh, the way the engine scatters them), then ``steps`` more
    steps, the refilled slot's clock restarted.  Returns the logits of every
    prefill and step (whole, f32), the greedy tokens fed back, and the first
    prefill's logits again from ``prefill_chunked`` (4 tokens a chunk)."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models import build_model
    from repro_torch.parallel.cache_specs import cache_pspecs
    from repro_torch.parallel.params import param_pspecs, shardings_from_specs
    from repro_torch.parallel.sharding import distribute, to_placements, use_sharding
    from repro_torch.serving.engine import cache_batch_axes, scatter_cache_slots
    from repro_torch.tree import tree_map

    mesh = _mesh((2, 2))
    model = build_model(_reduced_cfg("table_pack", 2, arch)
                        .replace(compute_dtype=compute_dtype), "cpu")
    like = _tensors(params)
    pl = shardings_from_specs(mesh, param_pspecs(like, mesh), like)
    dp = tree_map(lambda t, p: distribute(t, mesh, p), like, pl)
    B, S = prompts.shape
    fresh = model.init_cache(B, cache_len)
    cs = cache_pspecs(fresh, mesh)
    put = lambda c: {k: distribute(v, mesh, to_placements(cs[k], mesh)) for k, v in c.items()}
    rows = lambda t: distribute(torch.as_tensor(t), mesh, [Shard(0), Replicate()])
    out = {"logits": [], "tokens": [], "placements": {}}

    def prefill(toks):
        with use_sharding(mesh):
            logits, cache = model.prefill(dp, {"tokens": rows(toks)}, put(fresh))
        out["logits"].append(logits.full_tensor().float().numpy())
        return logits, cache

    logits, cache = prefill(prompts)
    out["placements"] = {k: _layout(v) for k, v in cache.items()}
    with use_sharding(mesh):  # the same prompts fed 4 tokens at a time
        chunked, _ = model.prefill_chunked(dp, {"tokens": rows(prompts)}, put(fresh), chunk=4)
    out["chunked"] = chunked.full_tensor().float().numpy()
    pos = np.full((B,), S, np.int32)

    def decode(logits, cache, pos):
        for _ in range(steps):
            tok = torch.argmax(logits.full_tensor(), dim=-1)[:, None].to(torch.int32)
            out["tokens"].append(tok.numpy()[:, 0].copy())
            with use_sharding(mesh):
                logits, cache = model.decode_step(dp, rows(tok), torch.as_tensor(pos), cache)
            out["logits"].append(logits.full_tensor().float().numpy())
            pos = pos + 1
        return logits, cache, pos

    logits, cache, pos = decode(logits, cache, pos)
    rlogits, rcache = prefill(refill)
    full = lambda c: {k: v.full_tensor() for k, v in c.items()}
    cache = put(scatter_cache_slots(full(cache), full(rcache), [slot],
                                    cache_batch_axes(model, cache_len)))
    lw = logits.full_tensor().clone()
    lw[slot] = rlogits.full_tensor()[slot]
    pos[slot] = S
    logits = distribute(lw, mesh, [Shard(0), Replicate()])
    decode(logits, cache, pos)
    return out


@task
def step_collectives(params, batch, cache_len, arch=None):
    """One decode step of reduced stablelm (or ``arch``; table_pack) placed
    by the dry run (``launch.dryrun.place_cell``, bf16 params) on a (2, 2)
    mesh, with its collectives counted (``CommDebugMode``) and their bytes;
    a batch with ``tokens`` and ``targets`` makes it one training step
    instead (the dry run's WUS placement, one micro-batch)."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.models import ShapeSpec, build_model

    mesh = _mesh((2, 2))
    model = build_model(_reduced_cfg("table_pack", 2, arch), "cpu")
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    if "targets" in batch:
        B, S = batch["tokens"].shape
        cell = dryrun.place_cell(model, ShapeSpec("train", S, B, "train"), mesh, "base",
                                 _tensors(params), batch, accum=1)
    else:
        B = batch["tok"].shape[0]
        shape = ShapeSpec("decode", cache_len, B, "decode")
        cell = dryrun.place_cell(model, shape, mesh, "base", _tensors(params), batch,
                                 model.init_cache(B, cache_len))
    return dryrun.collective_bytes(cell.run)


@task
def ddp_step(params, batch, lr):
    """One train step of reduced stablelm (table_pack, f32 compute) with its
    state placed as the dry run's ``ddp`` variant places it
    (``launch.dryrun.place_cell``: f32 params replicated, the AdamW moments
    ZeRO-1 over the flat mesh, the batch over every axis) on a (2, 2) mesh;
    AdamW off the mesh on the grads that step took; and the port's unmeshed
    step on the same weights and batch.  Then AdamW fed a grad in another
    layout than the one it allows for its parameter and moments."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.models import ShapeSpec, build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import use_sharding
    from repro_torch.train import loop as L
    from repro_torch.tree import leaves, unflatten

    mesh = _mesh((2, 2))
    model = build_model(_reduced_cfg("table_pack", 2).replace(compute_dtype="float32"),
                        "cpu")
    batch = L.batch_to(batch, "cpu")
    B, S = batch["tokens"].shape
    cell = dryrun.place_cell(model, ShapeSpec("train", S, B, "train"), mesh, "ddp",
                             _tensors(params), batch, accum=1)
    state, placed = cell.args
    opt = adamw.AdamWConfig(lr=lr, warmup_steps=0, total_steps=10, clip_norm=0.0)
    update, grads = adamw.update, []

    def capture(opt_cfg, p, g, st):
        grads.append([(t.full_tensor() if hasattr(t, "full_tensor") else t).numpy().copy()
                      for t in leaves(g)])
        return update(opt_cfg, p, g, st)

    full = lambda tree: [(t.full_tensor() if hasattr(t, "full_tensor") else t)
                         .detach().numpy().copy() for t in leaves(tree)]
    out = {"layout": {k: _layout(leaves(state[k] if k == "params" else state["opt"][k])[0])
                      for k in ("params", "m")}}
    before = full(state["params"])
    adamw.update = capture
    try:
        with use_sharding(mesh, cell.rules):
            state, metrics = L.make_train_step(model, opt)(state, placed)
        off = _tensors(params)
        off = {"params": off, "opt": adamw.init(off), "step": torch.zeros((), dtype=torch.int32)}
        off, off_metrics = L.make_train_step(model, opt)(off, batch)
    finally:
        adamw.update = update
    own = _tensors(params)
    update(opt, own, unflatten(own, [torch.from_numpy(g) for g in grads[0]]), adamw.init(own))
    out.update(loss=float(metrics["loss"]), off_loss=float(off_metrics["loss"]),
               grads=grads[0], off_grads=grads[1],
               delta=[b - a for a, b in zip(before, full(state["params"]))],
               own_delta=[b - a for a, b in zip(before, full(own))],
               off_delta=[b - a for a, b in zip(before, full(off["params"]))])
    # refused: a replicated parameter whose grad is sharded, and a ZeRO-1
    # parameter whose grad is replicated
    p, m = leaves(state["params"])[0], leaves(state["opt"]["m"])[0]
    out["refused"] = []
    for pp, g in ((p, m.clone()), (m.clone(), p.clone())):
        try:
            adamw.update(opt, [pp], [g], {"m": [m.clone()], "v": [m.clone()],
                                          "count": torch.zeros((), dtype=torch.int32)})
            out["refused"].append(None)
        except ValueError as e:
            out["refused"].append(str(e))
    return out


@task
def moe_layer_on_mesh(shape, params, x, r, cases):
    """One MoE block (``models.mlp.moe``) forward and backward on a ``shape``
    mesh (('data', 'model'), or ('pod', 'data', 'model') for three dims),
    its params placed by ``param_pspecs``' rules (experts over the 'expert'
    axes, the shared experts' GLU over 'ff'), x (B, S, d) over the batch
    axes; and the same block off the mesh on the same values.  ``cases``:
    (dtype, capacity_factor, device_groups, max_groups) each.  The loss is
    sum(y * r) + aux / 2.  Returns per case both outputs, aux losses and
    grads (x first, then the params' leaves), every slot's ``dest`` both
    ways (the mesh's through a spy on ``moe_dispatch`` with its chunk
    ``offset``), the local shapes of the expert weights and of the gate's
    buffer, and the shapes that every all-gather produced."""
    import torch
    from torch.distributed.tensor import Replicate
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import mlp
    from repro_torch.parallel.sharding import (P, default_rules, distribute, to_placements,
                                               use_sharding)
    from repro_torch.tree import leaves, tree_map

    mesh = _mesh(shape)
    rules = default_rules(mesh)
    ex = rules["expert"]
    specs = {"router": {"w": P()},
             "experts": {k: P(ex, None, None) for k in ("wi", "wu", "wd")},
             "shared": {"wi": {"w": P(None, "model")}, "wu": {"w": P(None, "model")},
                        "wd": {"w": P("model", None)}}}
    top_k = 2
    dispatch = mlp.moe_dispatch

    class Gathers(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if "all_gather" in str(func):
                self.shapes.append(tuple(out.shape))
            return out

    out = []
    for dtype, cf, groups, best in cases:
        dt = getattr(torch, dtype)
        kw = dict(top_k=top_k, capacity_factor=cf, device_groups=groups, max_groups=best)
        # off the mesh
        tp = tree_map(lambda t: t.to(dt).requires_grad_(True), _tensors(params))
        xt = torch.from_numpy(x).to(dt).requires_grad_(True)
        rt = torch.from_numpy(r).to(dt)
        seen = []
        mlp.moe_dispatch = lambda e, n, c, offset=None: seen.append(
            (e, offset, dispatch(e, n, c, offset))) or seen[-1][2]
        acts = []

        def act(v):
            acts.append(tuple(v.shape))
            return torch.nn.functional.silu(v)

        try:
            y0, a0 = mlp.moe(tp, xt, act, **kw)
            g0 = torch.autograd.grad((y0.float() * rt.float()).sum() + a0 / 2,
                                     [xt] + leaves(tp))
            off_dest = _slot_dest(*seen[-1])
            # on the mesh
            sp = {k: v for k, v in specs.items() if k in params}
            dp = tree_map(lambda t, s: distribute(t.to(dt), mesh, to_placements(s, mesh))
                          .requires_grad_(True), _tensors(params), sp)
            with use_sharding(mesh):
                xd = distribute(torch.from_numpy(x).to(dt), mesh,
                                to_placements(P(rules["batch"], None, None), mesh))
                xd.requires_grad_(True)
                seen.clear()
                acts.clear()
                gathers = Gathers()
                with gathers:
                    y, aux = mlp.moe(dp, xd, act, **kw)
                    yf = y.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
                    g = torch.autograd.grad((yf.float() * rt.float()).sum() + aux / 2,
                                            [xd] + leaves(dp))
        finally:
            mlp.moe_dispatch = dispatch
        (el, offset, res), = [s_ for s_ in seen if s_[1] is not None]
        full = lambda t: (t.full_tensor() if hasattr(t, "full_tensor") else t)
        out.append({
            "y": y0.detach().float().numpy(), "aux": float(a0),
            "grads": [t.float().numpy() for t in g0],
            "mesh_y": yf.detach().float().numpy(), "mesh_aux": float(aux),
            "mesh_grads": [full(t).float().numpy() for t in g],
            "dest": off_dest, "mesh_dest": _slot_dest(el, offset, res),
            "capacity": mlp.moe_capacity(x.shape[0] * x.shape[1], top_k,
                                         params["experts"]["wi"].shape[0], cf),
            "experts_local": {k: tuple(dp["experts"][k].to_local().shape)
                              for k in ("wi", "wu", "wd")},
            "gate_local": acts[0], "gathered": gathers.shapes})
    return out


def _slot_dest(eidx, offset, res):
    """Each (token, k) slot's ``dest`` (T, k) from a dispatch's sorted
    ``order`` and ``dest``."""
    order, dest = res
    return dest.new_empty(dest.shape).scatter_(0, order, dest).reshape(
        eidx.shape).numpy()
