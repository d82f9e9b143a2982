"""xLSTM blocks: mLSTM (matrix memory, exp input gating) and sLSTM (scalar
memory, recurrent gates) — arXiv:2405.04517; the JAX package's
``models/xlstm.py`` on PyTorch.

mLSTM recurrence per (batch, head), state C in R^{DxD}, normalizer n in R^D,
stabilizer m (scalar):

    m_t = max(logsig(f~_t) + m_{t-1}, i~_t)
    C_t = exp(logsig(f~)+m_{t-1}-m_t) C_{t-1} + exp(i~_t - m_t) v_t k_t^T
    n_t = (same decays) n + exp(i~ - m) k
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)

The chunkwise closed form tracks per-position running maxima inside each chunk
and rescales the carry: every exp() argument is clamped to <= 0, so the
paper's ``exp_neg`` table serves it (``act_exp``).  The reference's
``lax.scan`` over chunks is a loop here, and so is its scan over time in the
sLSTM, which keeps true recurrent gates (R h_{t-1}) and is sequential; decode
is the same loop with S=1.  The log-sigmoids are the reference's exact
``-softplus(-x)`` (``jax.nn.softplus``: ``logaddexp(x, 0)``), not the table.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.approx.activations import softplus

from .common import Params, init_linear, linear, min0, rmsnorm

STAB_INIT = -1e30  # the stabilizers' start, and the input gate's chunk padding


class MLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, H, D, D) stabilized matrix memory
    n: torch.Tensor  # (B, H, D) stabilized normalizer
    m: torch.Tensor  # (B, H) stabilizer (log scale)


class SLSTMCache(NamedTuple):
    h: torch.Tensor  # (B, d)
    c: torch.Tensor  # (B, d)
    n: torch.Tensor  # (B, d)
    m: torch.Tensor  # (B, d)


def init_mlstm(gen: torch.Generator, d_model: int, n_heads: int,
               dtype=torch.float32) -> Params:
    """The reference's tree and scales; the draws come from ``gen``."""
    dev = gen.device
    mk = lambda d_out: init_linear(gen, d_model, d_out, dtype=dtype)
    return {
        "wq": mk(d_model), "wk": mk(d_model), "wv": mk(d_model),
        "wi": mk(n_heads),  # input gate (exp)
        "wf": mk(n_heads),  # forget gate
        "wog": mk(d_model),  # output gate
        "norm": {"g": torch.ones((d_model,), dtype=dtype, device=dev)},
        "wo": mk(d_model),
        "f_bias": torch.full((n_heads,), 3.0, dtype=torch.float32, device=dev),
    }


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    # log sigmoid(x) = -softplus(-x)
    return -softplus(-x)


def mlstm_block(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    *,
    n_heads: int,
    act_sigmoid: Callable,
    act_exp: Callable,  # exp over (-inf, 0] — the exp_neg table
    cache: Optional[MLSTMCache] = None,
    chunk: int = 128,
):
    B, S, d = x.shape
    H = n_heads
    D = d // H
    f32 = torch.float32

    def split_heads(t):  # (B,S,d) -> (B,H,S,D)
        return t.reshape(B, S, H, D).movedim(2, 1)

    q = split_heads(linear(p["wq"], x)).to(f32) * (D ** -0.5)
    k = split_heads(linear(p["wk"], x)).to(f32) * (D ** -0.5)
    v = split_heads(linear(p["wv"], x)).to(f32)
    it = linear(p["wi"], x).movedim(2, 1).to(f32)  # (B,H,S) i~
    ft = linear(p["wf"], x).movedim(2, 1).to(f32) + p["f_bias"][None, :, None]
    logf = _logsigmoid(ft)  # (B,H,S) <= 0

    if cache is None:
        c, n = x.new_zeros((B, H, D, D), dtype=f32), x.new_zeros((B, H, D), dtype=f32)
        m = x.new_full((B, H), STAB_INIT, dtype=f32)
    else:
        c, n, m = cache.c.to(f32), cache.n.to(f32), cache.m

    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        zpad = lambda t: F.pad(t, (0, 0, 0, pad))
        q, k, v = zpad(q), zpad(k), zpad(v)
        it = F.pad(it, (0, pad), value=STAB_INIT)
        logf = F.pad(logf, (0, pad))
    nch = (S + pad) // L
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))

    hs = []
    for ci in range(nch):
        sl = slice(ci * L, (ci + 1) * L)
        qc, kc, vc = q[:, :, sl], k[:, :, sl], v[:, :, sl]
        ic, fc = it[..., sl], logf[..., sl]
        cl = torch.cumsum(fc, dim=-1)  # (B,H,L) cumulative log forget
        # log-weight of source j at target i: cl_i - cl_j + i~_j  (j <= i)
        src = ic - cl  # (B,H,L) at j
        # per-position running stabilizer: m_i = max(m_prev + cl_i, max_{j<=i} cl_i + src_j)
        run_src = torch.cummax(src, dim=2).values
        m_i = torch.maximum(m[..., None] + cl, cl + run_src)  # (B,H,L)
        # carry term
        carry_w = act_exp(min0(m[..., None] + cl - m_i))
        y_carry = carry_w[..., None] * torch.einsum("bhde,bhle->bhld", c, qc)
        nq_carry = carry_w * torch.einsum("bhd,bhld->bhl", n, qc)
        # intra term: W_ij = cl_i - cl_j + i~_j - m_i
        gap = cl[..., :, None] - cl[..., None, :] + ic[..., None, :]
        w_ij = gap - m_i[..., None]
        pw = torch.where(mask, act_exp(min0(w_ij)), 0.0)
        g = torch.einsum("bhld,bhmd->bhlm", qc, kc)  # q_i . k_j
        y_intra = torch.einsum("bhlm,bhmd->bhld", pw * g, vc)
        nq_intra = torch.einsum("bhlm,bhlm->bhl", pw, g)
        h_num = y_carry + y_intra
        nq = nq_carry + nq_intra
        denom = torch.maximum(torch.abs(nq), act_exp(min0(-m_i)))
        h = h_num / torch.clamp(denom, min=1e-30)[..., None]
        # new carry at chunk end
        m_new = torch.maximum(m + cl[..., -1], cl[..., -1] + run_src[..., -1])
        cw = act_exp(min0(m + cl[..., -1] - m_new))
        dj = act_exp(min0(cl[..., -1:] - cl + ic - m_new[..., None]))
        c = cw[..., None, None] * c + torch.einsum("bhm,bhmd,bhme->bhde", dj, vc, kc)
        n = cw[..., None] * n + torch.einsum("bhm,bhmd->bhd", dj, kc)
        m = m_new
        hs.append(h)
    h = torch.cat(hs, dim=2)[:, :, :S]
    h = h.movedim(1, 2).reshape(B, S, d).to(x.dtype)
    og = act_sigmoid(linear(p["wog"], x))
    h = rmsnorm(p["norm"], h) * og
    return linear(p["wo"], h), MLSTMCache(c, n, m)


def init_slstm(gen: torch.Generator, d_model: int, dtype=torch.float32) -> Params:
    """The reference's tree and scales; the draws come from ``gen``."""
    dev = gen.device
    mk = lambda: init_linear(gen, d_model, d_model, dtype=dtype)
    p = {k: mk() for k in ("wz", "wi", "wf", "wo", "rz", "ri", "rf", "ro")}
    p["f_bias"] = torch.full((d_model,), 3.0, dtype=torch.float32, device=dev)
    p["norm"] = {"g": torch.ones((d_model,), dtype=dtype, device=dev)}
    p["wd"] = mk()
    return p


def slstm_block(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    *,
    act_sigmoid: Callable,
    act_tanh: Callable,
    act_exp: Callable,
    cache: Optional[SLSTMCache] = None,
):
    B, S, d = x.shape
    f32 = torch.float32
    if cache is None:
        cache = init_slstm_cache(B, d, x.device)
    zx = linear(p["wz"], x).to(f32)
    ix = linear(p["wi"], x).to(f32)
    fx = linear(p["wf"], x).to(f32) + p["f_bias"]
    ox = linear(p["wo"], x).to(f32)
    rz, ri, rf, ro = (p[k]["w"].to(f32) for k in ("rz", "ri", "rf", "ro"))

    h, c, n, m = (t.to(f32) for t in cache)
    hs = []
    for t in range(S):
        zt = act_tanh(zx[:, t] + h @ rz)
        i_t = ix[:, t] + h @ ri
        f_t = fx[:, t] + h @ rf
        logf = -softplus(-f_t)  # log sigmoid
        m_new = torch.maximum(logf + m, i_t)
        ip = act_exp(min0(i_t - m_new))
        fp = act_exp(min0(logf + m - m_new))
        c = fp * c + ip * zt
        n = fp * n + ip
        h_tilde = c / torch.clamp(n, min=1e-6)
        o = act_sigmoid(ox[:, t] + h @ ro)
        h = o * h_tilde
        m = m_new
        hs.append(h)
    hseq = torch.stack(hs, dim=1).to(x.dtype)  # (B, S, d)
    out = linear(p["wd"], rmsnorm(p["norm"], hseq))
    return out, SLSTMCache(h, c, n, m)


def init_mlstm_cache(batch: int, d_model: int, n_heads: int, device=None) -> MLSTMCache:
    D = d_model // n_heads
    f32 = torch.float32
    return MLSTMCache(
        c=torch.zeros((batch, n_heads, D, D), dtype=f32, device=device),
        n=torch.zeros((batch, n_heads, D), dtype=f32, device=device),
        m=torch.full((batch, n_heads), STAB_INIT, dtype=f32, device=device))


def init_slstm_cache(batch: int, d_model: int, device=None) -> SLSTMCache:
    z = lambda: torch.zeros((batch, d_model), dtype=torch.float32, device=device)
    return SLSTMCache(h=z(), c=z(), n=z(),
                      m=torch.full((batch, d_model), STAB_INIT, dtype=torch.float32,
                                   device=device))
