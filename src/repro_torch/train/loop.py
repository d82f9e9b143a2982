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

PyTorch runs eagerly: there is no jit, and the step updates the state in
place (:func:`repro_torch.optim.adamw.update`).  An exception inside that
update leaves the state partly updated, and the emergency checkpoint then
holds it as it is.  The mesh, weight-update sharding and ZeRO-1 wait for the
mesh path (ROADMAP queue 1, item 12b): ``run(mesh=...)`` raises.
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
from repro_torch.tree import leaves, unflatten

from .checkpoint import CheckpointManager


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_keep: int = 3
    accum: int = 1  # gradient-accumulation microbatches
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


def make_train_step(model, opt_cfg: adamw.AdamWConfig, accum: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``; state =
    ``{"params", "opt", "step"}``, updated in place and returned.  The grads
    come from :func:`accumulated_grads`."""

    def train_step(state, batch):
        params = state["params"]
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


def run(model, shape, cfg: TrainConfig, mesh=None,
        log: Callable[[str], None] = print) -> Dict[str, Any]:
    """End-to-end training with restart.  Returns the final metrics summary;
    ``build_time_s`` is the wall time of the steps during which a CUDA kernel
    was built (nvcc), the port's counterpart of the reference's compile
    time."""
    if mesh is not None:
        raise NotImplementedError(
            "training over a mesh (weight-update sharding, ZeRO-1) is not "
            "ported yet: ROADMAP queue 1, item 12b (the mesh path)")
    data = SyntheticLM(data_config_for(model.cfg, shape))
    ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep)
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
    step0, restored = ckpt.restore_latest(state)
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
    try:
        while step < cfg.steps and not stop["flag"]:
            batch = batch_to(data.batch_at(step), model.device)
            if rec:
                tracer.begin("train.step", "train", step=step)
            built_before = _build.build_seconds()
            t0 = time.perf_counter()
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
