"""Attention: GQA with RoPE, flash attention as plain PyTorch ops (two-level
chunked running softmax), and KV caches with per-slot positions.

Flash attention is plain jnp in the JAX package (not a Pallas kernel), so it is
plain PyTorch here, with the same ``exp_fn`` hook: TableFlash serves the two
running-softmax exponents from the pack's ``exp_neg`` member through the CUDA
kernel of :mod:`repro_torch.kernels.table_pack_lookup`.

GQA never materializes repeated KV inside flash: einsums carry a
(groups, q_per_kv) axis.  Shapes: q (B, S, G, Qg, D); k,v (B, T, G, D).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import einsum, is_dtensor, on_local_shards, replicate_like

from .common import Params, apply_rope, init_linear, linear

NEG_INF = -2.0e38
# Sentinel for CHUNK-PADDING key slots added inside _flash_inner (Tp > T),
# distinct from the genuine "empty cache slot" marker (k_pos == -1).  Any
# negative value masks identically (`valid = k_pos >= 0`).
KV_PAD = -(1 << 31)
# query-padding positions (beyond every key): masked by the causal test
Q_PAD_POS = 2_000_000_000


def init_attention(gen: torch.Generator, d_model: int, geom, qk_norm: bool = False,
                   dtype=torch.float32) -> Params:
    """Weights use the *normalized* geometry: q carries ``h_eff`` padded heads
    (masked in the forward — function-preserving); k/v stay at the logical
    ``g_log`` heads.  ``wo`` is stored as (g_eff, q_per_group, D, d_model), the
    layout ``attention_out`` contracts."""
    wo = torch.randn((geom.h_eff, geom.d_head, d_model), generator=gen,
                     device=gen.device, dtype=dtype).mul_(0.02)
    p = {
        "wq": init_linear(gen, d_model, (geom.h_eff, geom.d_head), dtype=dtype),
        "wk": init_linear(gen, d_model, (geom.g_log, geom.d_head), dtype=dtype),
        "wv": init_linear(gen, d_model, (geom.g_log, geom.d_head), dtype=dtype),
        "wo": {"w": wo.reshape(geom.g_eff, geom.q_per_group, geom.d_head, d_model)},
    }
    if qk_norm:
        p["qn"] = {"g": torch.ones((geom.d_head,), dtype=dtype, device=gen.device)}
        p["kn"] = {"g": torch.ones((geom.d_head,), dtype=dtype, device=gen.device)}
    return p


def _headnorm(g, x, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * g.to(torch.float32)).to(x.dtype)


def head_mask(geom) -> np.ndarray:
    """(g_eff, q_per_group) 1/0 mask of REAL heads in the normalized layout."""
    if geom.g_zero_pad:
        m = np.zeros((geom.g_eff, geom.q_per_group), np.float32)
        m[: geom.g_log] = 1.0
        return m
    per_group = geom.h_eff // geom.g_log
    qg_real = geom.h_log // geom.g_log
    per_rep = per_group // geom.repeat
    mg = np.concatenate([np.ones(qg_real, np.float32),
                         np.zeros(per_group - qg_real, np.float32)])
    m = np.tile(mg.reshape(1, geom.repeat, per_rep), (geom.g_log, 1, 1))
    return m.reshape(geom.g_eff, per_rep)


def project_qkv(p: Params, x: torch.Tensor, positions: Optional[torch.Tensor], *,
                geom, rope_theta: float, rope_sin_cos=None):
    """x: (B,S,d) -> q (B,S,g_eff,Qg,D), k/v (B,S,g_eff,D) in normalized layout.
    positions: (S,) shared across the batch, or (B, S) per-slot clocks;
    ``None`` or ``rope_theta == 0`` skips RoPE (whisper's absolute
    positions)."""
    B, S, _ = x.shape
    q = linear(p["wq"], x, "bsd,dhe->bshe")  # (B,S,h_eff,D)
    if "qn" in p:
        q = _headnorm(p["qn"]["g"], q)
    if positions is not None and rope_theta > 0:
        pos_b = positions if positions.dim() == 2 else positions[None, :]
        q = apply_rope(q, pos_b, rope_theta, sin_cos=rope_sin_cos)
    k, v = project_kv(p, x, positions, geom=geom, rope_theta=rope_theta,
                      rope_sin_cos=rope_sin_cos)
    q = q.reshape(B, S, geom.g_eff, geom.q_per_group, geom.d_head)
    return q, k, v


def project_kv(p: Params, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
               *, geom, rope_theta: float = 0.0, rope_sin_cos=None):
    """The k/v half of ``project_qkv``: (B,S,d) -> k/v (B,S,g_eff,D).  A
    decoder's cross-attention projects the encoder memory through it (the
    reference projects q as well and drops it)."""
    k = linear(p["wk"], x, "bsd,dge->bsge")  # (B,S,g_log,D)
    v = linear(p["wv"], x, "bsd,dge->bsge")
    if "kn" in p:
        k = _headnorm(p["kn"]["g"], k)
    if positions is not None and rope_theta > 0:
        pos_b = positions if positions.dim() == 2 else positions[None, :]
        k = apply_rope(k, pos_b, rope_theta, sin_cos=rope_sin_cos)
    # normalize kv to g_eff groups on the ACTIVATION (params stay logical)
    if geom.repeat > 1:
        k = torch.repeat_interleave(k, geom.repeat, dim=2)
        v = torch.repeat_interleave(v, geom.repeat, dim=2)
    elif geom.g_zero_pad:
        k = F.pad(k, (0, 0, 0, geom.g_zero_pad))
        v = F.pad(v, (0, 0, 0, geom.g_zero_pad))
    return k, v


def _flash_inner(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
                 kv_chunk: int, scale: float, exp_fn=None):
    """Running-softmax attention for one q block over all kv chunks.

    q: (B, Sq, G, Qg, D); k/v: (B, T, G, D); positions: (Sq,) / (T,) shared
    across the batch, or (B, Sq) / (B, T) per-slot.  Returns (B, Sq, G, Qg, D).
    ``exp_fn`` serves the two running-softmax exponents (arguments <= 0 by
    construction); None keeps exact ``torch.exp``.  An instrumented closure
    advertising ``wants_count_mask`` also receives a ``count_mask`` that
    excludes the KV_PAD chunk-padding keys from its underflow telemetry;
    any other ``exp_fn`` runs the same operators as without telemetry.
    """
    B, Sq, G, Qg, D = q.shape
    T = k.shape[1]
    kv_chunk = min(kv_chunk, T)
    n_chunks = -(-T // kv_chunk)
    pad = n_chunks * kv_chunk - T
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=KV_PAD)
    qp = q_pos if q_pos.dim() == 2 else q_pos[None, :]  # (1|B, Sq)
    exp = torch.exp if exp_fn is None else exp_fn
    count_pad = getattr(exp_fn, "wants_count_mask", False)

    # the scale rounds to q's dtype first, as the JAX weak-typed scalar does
    qf = (q * torch.tensor(scale, dtype=q.dtype, device=q.device)).to(torch.float32)
    m = torch.full((B, Sq, G, Qg), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, G, Qg), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, G, Qg, D), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        kc, vc, kp = k[:, sl], v[:, sl], k_pos[..., sl]
        s = torch.einsum("bsgqd,btgd->bsgqt", qf, kc.to(torch.float32))
        kpb = kp if kp.dim() == 2 else kp[None, :]  # (1|B, Tc)
        valid = kpb[:, None, :] >= 0  # empty slots masked
        if causal:
            valid = valid & (kpb[:, None, :] <= qp[:, :, None])
        if window > 0:
            valid = valid & (kpb[:, None, :] > qp[:, :, None] - window)
        s = torch.where(valid[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        if count_pad:
            # pad lanes are a chunking artifact, not approximation events
            countable = (kpb != KV_PAD)[:, None, None, None, :]
            p = exp(s - m_new[..., None], count_mask=countable.expand(s.shape))
        else:
            p = exp(s - m_new[..., None])
        alpha = exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bsgqt,btgd->bsgqd", p, vc.to(torch.float32))
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True, window: int = 0,
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    exp_fn=None) -> torch.Tensor:
    """q: (B, S, G, Qg, D); k/v: (B, T, G, D).  Positions are absolute token
    indices; negative k_pos marks empty cache slots.  Either positions operand
    may carry a leading batch axis ((B, S) / (B, T)) for per-slot clocks.
    ``exp_fn`` routes the softmax exponent through the exp_neg table
    (TableFlash; see ``_flash_inner``).  DTensor q/k/v (a mesh) run on their
    local shards: attention is local to a batch row and a kv group, so k and
    v are first laid out as q is (a local chunk when they are replicated)."""
    if is_dtensor(q):
        if q_pos.dim() > 1 or k_pos.dim() > 1:
            raise NotImplementedError("per-slot positions on a mesh: ROADMAP "
                                      "queue 1, item 12c")
        mesh, pl = q.device_mesh, tuple(q.placements)
        k, v = k.redistribute(mesh, pl), v.redistribute(mesh, pl)
        return on_local_shards(
            lambda a, b, c: flash_attention(a, b, c, q_pos, k_pos, causal=causal,
                                            window=window, q_chunk=q_chunk,
                                            kv_chunk=kv_chunk, exp_fn=exp_fn),
            pl, q, k, v)
    B, S, G, Qg, D = q.shape
    scale = D ** -0.5
    q_chunk = min(q_chunk, S)
    pad = q_chunk * (-(-S // q_chunk)) - S
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad), value=Q_PAD_POS)
    outs = []
    for c in range(q.shape[1] // q_chunk):
        sl = slice(c * q_chunk, (c + 1) * q_chunk)
        outs.append(_flash_inner(q[:, sl], k, v, q_pos[..., sl], k_pos,
                                 causal=causal, window=window, kv_chunk=kv_chunk,
                                 scale=scale, exp_fn=exp_fn))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out[:, :S]


def attention_out(p: Params, attended: torch.Tensor, geom=None) -> torch.Tensor:
    """(B, S, G, Qg, D) -> (B, S, d_model) via the output projection.  Padded
    heads are masked here (the normalized model is exactly the logical one)."""
    if geom is not None and geom.is_padded:
        mask = replicate_like(torch.as_tensor(head_mask(geom), device=attended.device),
                              attended)
        attended = attended * mask[None, None, :, :, None].to(attended.dtype)
    wo = p["wo"]["w"].to(attended.dtype)  # (G, Qg, D, d_model)
    return einsum("bsgqd,gqdm->bsm", attended, wo)


def cache_insert(k_buf, v_buf, pos_buf, k_new, v_new, positions):
    """Insert S new rope'd entries into a ring/linear buffer; returns NEW
    buffers (the inputs are left as they were, like the JAX package's
    functional update: engines keep a pristine cache to prefill from).

    k_buf/v_buf: (B, W, G, D); pos_buf: (B, W) int32 per-slot validity rows
    (-1 = empty slot).  positions: (S,) absolute shared across the batch, or
    (B, S) per-slot; slot = position % W.  Callers pass S <= W.
    """
    B, W = k_buf.shape[:2]
    pos2 = torch.atleast_2d(positions).expand(B, positions.shape[-1])
    slots = (pos2 % W).to(torch.int64)
    b = torch.arange(B, device=k_buf.device)[:, None].expand_as(slots)
    k_buf = k_buf.index_put((b, slots), k_new.to(k_buf.dtype))
    v_buf = v_buf.index_put((b, slots), v_new.to(v_buf.dtype))
    pos_buf = pos_buf.index_put((b, slots), pos2.to(torch.int32))
    return k_buf, v_buf, pos_buf
