"""AdamW with decoupled weight decay, global-norm clipping and a
warmup-cosine schedule — the JAX package's ``optim/adamw.py`` on PyTorch.

State = ``{"m", "v", "count"}``: f32 moments in the parameters' tree
structure (nested dicts and lists of tensors) and a 0-d int32 step count.
Every quantity is computed in f32 on the parameters' device, op for op as in
the reference.  :func:`update` writes the new parameters and moments IN PLACE
(no second copy of a 2.8 B-parameter model and its moments), and returns the
same objects.  On a mesh the parameters, grads and moments are DTensors,
usually in one layout (the ZeRO-1 master layout): the global norm is taken
over the mesh and the elementwise update runs on each rank's local shards
of the moments' layout.  The one other layout allowed: a replicated
parameter, its grad replicated or a pending sum, over moments in the ZeRO-1
layout (the dry run's ``ddp``).  The grad is reduce-scattered to the
moments' layout, the shard updated there and gathered back.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.parallel.sharding import is_dtensor
from repro_torch.tree import leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor): linear warmup, then cosine decay
    to ``min_lr_ratio * lr``."""
    step = step.to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    t = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in leaves(tree)))


@torch.no_grad()
def update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step.  Returns ``(params, state, metrics)``; ``params`` and
    ``state`` are the objects passed in, updated in place (``grads`` is left
    as it was).  Weight decay applies to matrices (ndim >= 2) only."""
    count = state["count"] + 1
    gn = global_norm(grads)
    if is_dtensor(gn):
        gn = gn.full_tensor()
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0) \
        if cfg.clip_norm > 0 else 1.0
    lr = schedule(cfg, count)
    b1c = 1.0 - cfg.b1 ** count.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** count.to(torch.float32)

    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        whole = None
        if is_dtensor(p):  # the update is local to each shard of the moments
            same = p.placements == g.placements == m.placements == v.placements
            zero1 = (m.placements == v.placements
                     and all(q.is_replicate() for q in p.placements)
                     and not any(q.is_shard() for q in g.placements))
            if not (same or zero1):
                raise ValueError("a parameter, its grad and moments must share one "
                                 "layout, or a replicated parameter and its grad "
                                 "meet moments in another")
            if not same:  # ZeRO-1 over replicated params: update the shard
                whole = p
                p = p.redistribute(m.device_mesh, m.placements)
                g = g.redistribute(m.device_mesh, m.placements)
            shards, p = p, p.to_local()
            g, m, v = (t.to_local() for t in (g, m, v))
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            step = step + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * step)
        if whole is not None:  # the updated shards gathered into the parameter
            whole.to_local().copy_(shards.redistribute(whole.device_mesh,
                                                       whole.placements).to_local())
    state["count"] = count
    return params, state, {"grad_norm": gn, "lr": lr}


def compress_grads_bf16(grads):
    """Optional gradient compression before the cross-pod reduction: halves
    the inter-pod collective bytes at ~1 ulp bf16 cost (the reference's)."""
    return tree_map(lambda g: g.to(torch.bfloat16), grads)
