"""Shared building blocks: initializers, norms, rotary embeddings, projections.

Parameters are plain nested dicts of tensors, in the JAX package's layouts
(e.g. a linear weight is ``(d_in, *d_out)``), so a JAX parameter tree converts
one to one (:mod:`repro_torch.convert`) and the functions here are the JAX
ones written with PyTorch ops.  Initializers draw from an explicit
``torch.Generator`` on the target device: same distributions as the reference,
not the same bits.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.parallel.sharding import einsum, elementwise, is_dtensor, vocab_lookup

Params = Dict[str, Any]


def normal_init(gen: torch.Generator, shape, scale: float,
                dtype=torch.float32) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 1 else 1
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
    return w.mul_(scale / max(1, fan_in) ** 0.5)


def init_linear(gen: torch.Generator, d_in: int, d_out, *, scale: float = 1.0,
                dtype=torch.float32) -> Params:
    """Weight of shape (d_in, *d_out) — d_out may be a tuple for fused heads."""
    shape = (d_in,) + (d_out if isinstance(d_out, tuple) else (d_out,))
    return {"w": normal_init(gen, shape, scale, dtype)}


def linear(p: Params, x: torch.Tensor, dims: str = "...d,df->...f") -> torch.Tensor:
    return einsum(dims, x, p["w"].to(x.dtype))


def init_rmsnorm(d: int, device, dtype=torch.float32) -> Params:
    return {"g": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["g"].to(torch.float32)).to(x.dtype)


def init_layernorm(d: int, device, dtype=torch.float32) -> Params:
    return {"g": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"].to(torch.float32) + p["b"].to(torch.float32)).to(x.dtype)


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32) -> Params:
    table = torch.randn((vocab, d), generator=gen, device=gen.device, dtype=dtype)
    return {"table": table.mul_(0.02)}


def min0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum(x, 0.0)``: a tie at 0 passes half the gradient, as in
    JAX (``clamp`` would pass all of it)."""
    return torch.minimum(x, x.new_zeros(()))


def embed(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return vocab_lookup(p["table"], tokens).to(dtype)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Project to vocab logits in f32 (loss stability)."""
    return einsum("...d,vd->...v", x.to(torch.float32), p["table"].to(torch.float32))


# ------------------------------- rotary ---------------------------------------


def rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sin_cos=None) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: broadcastable to (..., S).

    ``sin_cos`` optionally replaces the exact trig with a table-served
    ``f(ang) -> (sin, cos)`` (``ApproxConfig.rope_sin_cos()``); ``None`` keeps
    exact rotations."""
    if is_dtensor(x):  # local to a position and a head: on x's local shards
        return elementwise(lambda xl: apply_rope(xl, positions, theta, sin_cos), x)
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (D/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, D/2)
    if sin_cos is None:
        cos, sin = torch.cos(ang), torch.sin(ang)
    else:
        sin, cos = sin_cos(ang)
    if x.dim() == ang.dim() + 1:  # head axis present between S and D
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) absolute position embeddings [sin | cos], computed in float64
    numpy and rounded once to f32, as the reference does."""
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * i / d)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb.astype(np.float32)).to(device)


def softcap(x: torch.Tensor, cap: float, tanh_fn=None) -> torch.Tensor:
    """Soft logit cap ``cap * tanh(x / cap)``; ``tanh_fn`` routes the tanh
    through the approx backend (``cfg.approx.unary("tanh")``)."""
    if cap <= 0:
        return x
    t = torch.tanh if tanh_fn is None else tanh_fn
    return cap * t(x / cap)


def routed_activation(approx, names, device=None) -> Any:
    """MoE-style slot-routed activations: ``f(x)`` applies ``names[i]`` to
    row i of a slot-major tensor ``(n_slots, ...)`` in ONE call.

    ``approx`` is the model's :class:`repro_torch.approx.ApproxConfig` and
    ``device`` where its tables live.  In table modes the dispatch runs
    through the routed kernels: the slot->function assignment is a device
    operand, so one kernel serves every routing; exact mode falls back to a
    row-select over the exact activations.
    """
    return approx.routed_fn(tuple(names), device)
