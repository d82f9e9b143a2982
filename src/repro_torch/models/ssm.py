"""Mamba2 (SSD) blocks on a chunkwise gated outer-product scan — the JAX
package's ``models/ssm.py`` on PyTorch.

Recurrence (per batch, head):   S_t = a_t * S_{t-1} + u_t w_t^T,   y_t = S_t r_t
with S in R^{P x N}, a_t in (0, 1].  The chunkwise closed form (chunk length L):

    y_i = exp(lA_i) * (S_0 r_i) + sum_{j<=i} exp(lA_i - lA_j) (w_j . r_i) u_j
    S_L = exp(lA_L) * S_0 + sum_j exp(lA_L - lA_j) u_j w_j^T

where lA is the within-chunk cumulative log-decay.  Peak memory is O(B H L^2)
per chunk (L = 256 by default).  The reference's ``lax.scan`` over chunks is a
loop here.  The decay's exp is exact ``torch.exp``, as the reference's code has
it (``jnp.exp``); softplus (for dt) and silu (the conv outputs and the gate)
go through the model's approx backend.

Projections are kept unfused (separate z/x/B/C/dt weights), as in the
reference's parameter tree.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .common import Params, init_linear, linear, min0, rmsnorm


def gated_outer_scan(log_a, u, w, r, s0, chunk: int = 256):
    """Chunk-parallel scan of S_t = a_t S_{t-1} + u_t w_t^T ; y_t = S_t r_t.

    log_a: (B, H, S); u: (B, H, S, P); w, r: (B, H, S, N); s0: (B, H, P, N).
    S must be a multiple of ``chunk`` (callers pad).  Returns (y, s_final).
    """
    B, H, S, P = u.shape
    N = w.shape[-1]
    L = min(chunk, S)
    n_chunks = S // L
    la = log_a.reshape(B, H, n_chunks, L)
    uc = u.reshape(B, H, n_chunks, L, P)
    wc = w.reshape(B, H, n_chunks, L, N)
    rc = r.reshape(B, H, n_chunks, L, N)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=u.device))

    s, ys = s0, []
    for i in range(n_chunks):
        la_, u_, w_, r_ = la[:, :, i], uc[:, :, i], wc[:, :, i], rc[:, :, i]
        cl = torch.cumsum(la_, dim=-1)  # within-chunk cumulative log decay
        y_carry = torch.exp(cl)[..., None] * torch.einsum("bhpn,bhln->bhlp", s, r_)
        gap = cl[..., :, None] - cl[..., None, :]  # (B,H,L,L) i x j
        t = torch.where(mask, torch.exp(min0(gap)), 0.0)
        g = torch.einsum("bhln,bhmn->bhlm", r_, w_)
        y_intra = torch.einsum("bhlm,bhmp->bhlp", t * g, u_)
        decay_to_end = torch.exp(cl[..., -1:] - cl)
        s = torch.exp(cl[..., -1])[..., None, None] * s + torch.einsum(
            "bhm,bhmp,bhmn->bhpn", decay_to_end, u_, w_)
        ys.append(y_carry + y_intra)
    return torch.stack(ys, dim=2).reshape(B, H, S, P), s


class SSMCache(NamedTuple):
    state: torch.Tensor  # (B, H, P, N) f32
    conv_x: torch.Tensor  # (B, K-1, inner)
    conv_b: torch.Tensor  # (B, K-1, N)
    conv_c: torch.Tensor  # (B, K-1, N)


def init_mamba2(gen: torch.Generator, d_model: int, *, expand: int, head_dim: int,
                state_dim: int, conv_width: int, dtype=torch.float32) -> Params:
    """The reference's tree and scales; the draws come from ``gen``."""
    inner = expand * d_model
    n_heads = inner // head_dim
    dev = gen.device
    conv = lambda c: {"w": torch.randn((conv_width, c), generator=gen, device=dev,
                                       dtype=dtype).mul_(0.2)}
    return {
        "in_z": init_linear(gen, d_model, inner, dtype=dtype),
        "in_x": init_linear(gen, d_model, inner, dtype=dtype),
        "in_b": init_linear(gen, d_model, state_dim, dtype=dtype),
        "in_c": init_linear(gen, d_model, state_dim, dtype=dtype),
        "in_dt": init_linear(gen, d_model, n_heads, dtype=dtype),
        "conv_x": conv(inner),
        "conv_b": conv(state_dim),
        "conv_c": conv(state_dim),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=torch.float32,
                                          device=dev)),
        "d_skip": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "norm": {"g": torch.ones((inner,), dtype=dtype, device=dev)},
        "out": init_linear(gen, inner, d_model, dtype=dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, carry: Optional[torch.Tensor]):
    """Depthwise causal conv. x: (B, S, C); w: (K, C); carry: (B, K-1, C) or None.
    Returns (out, new_carry)."""
    K, S = w.shape[0], x.shape[1]
    if carry is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = carry.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    wx = w.to(x.dtype)
    out = xp[:, 0:S] * wx[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * wx[i]
    return out, xp[:, -(K - 1):]


def mamba2_block(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    *,
    expand: int,
    head_dim: int,
    state_dim: int,
    conv_width: int,
    chunk: int,
    act_silu: Callable,
    act_softplus: Callable,
    cache: Optional[SSMCache] = None,
):
    """Returns (y, new_cache).  S == 1 takes one recurrence step; a longer S
    is padded to a multiple of ``chunk`` (zero decay, zero input) for the
    scan."""
    B, S, d = x.shape
    inner = expand * d
    H = inner // head_dim
    N = state_dim
    f32 = torch.float32

    z = linear(p["in_z"], x)
    xin = linear(p["in_x"], x)
    b = linear(p["in_b"], x)
    c = linear(p["in_c"], x)
    dt_raw = linear(p["in_dt"], x)

    xin, ncx = _causal_conv(xin, p["conv_x"]["w"], cache.conv_x if cache else None)
    b, ncb = _causal_conv(b, p["conv_b"]["w"], cache.conv_b if cache else None)
    c, ncc = _causal_conv(c, p["conv_c"]["w"], cache.conv_c if cache else None)
    xin = act_silu(xin)
    b = act_silu(b)
    c = act_silu(c)

    dt = act_softplus(dt_raw.to(f32) + p["dt_bias"])  # (B,S,H)
    a = -torch.exp(p["a_log"])  # (H,) negative
    log_decay = (dt * a).movedim(2, 1)  # (B,H,S) <= 0

    u = (xin.reshape(B, S, H, head_dim).to(f32) * dt[..., None]).movedim(2, 1)
    w_ = b[:, None].to(f32).expand(B, H, S, N)
    r_ = c[:, None].to(f32).expand(B, H, S, N)

    s0 = (cache.state.to(f32) if cache is not None
          else x.new_zeros((B, H, head_dim, N), dtype=f32))

    if S == 1:  # decode fast path: one recurrence step
        a1 = torch.exp(log_decay[..., 0])
        s_final = a1[..., None, None] * s0 + torch.einsum(
            "bhp,bhn->bhpn", u[..., 0, :], w_[..., 0, :])
        y = torch.einsum("bhpn,bhn->bhp", s_final, r_[..., 0, :])[:, None]  # (B,1,H,P)
    else:
        pad = (-S) % chunk
        if pad:
            padded = lambda t: F.pad(t, (0, 0) * (t.dim() - 3) + (0, pad))
            log_decay, u, w_, r_ = (padded(log_decay), padded(u), padded(w_),
                                    padded(r_))
        y, s_final = gated_outer_scan(log_decay, u, w_, r_, s0, chunk)
        y = y[:, :, :S].movedim(1, 2)  # (B,S,H,P)

    y = y + (xin.reshape(B, S, H, head_dim).to(f32) * p["d_skip"][None, None, :, None])
    y = y.reshape(B, S, inner).to(x.dtype)
    y = rmsnorm(p["norm"], y * act_silu(z))
    out = linear(p["out"], y)
    new_cache = SSMCache(state=s_final.to(f32), conv_x=ncx.to(f32),
                         conv_b=ncb.to(f32), conv_c=ncc.to(f32))
    return out, new_cache


def init_ssm_cache(batch: int, inner: int, state_dim: int, head_dim: int,
                   conv_width: int, device=None) -> SSMCache:
    H = inner // head_dim
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return SSMCache(state=z(batch, H, head_dim, state_dim),
                    conv_x=z(batch, conv_width - 1, inner),
                    conv_b=z(batch, conv_width - 1, state_dim),
                    conv_c=z(batch, conv_width - 1, state_dim))
