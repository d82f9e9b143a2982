"""DecoderLM — the dense and MoE GQA transformer behind one API (the JAX
package's ``models/transformer.py::DecoderLM``), period-1 and local:global
stacks:

    model = build_model(cfg, device=...)          # repro_torch.models.registry
    params = model.init(generator)
    logits, aux = model.train_logits(params, batch)
    loss = model.loss(params, batch)
    cache = model.init_cache(batch_size, cache_len)
    logits, cache = model.prefill(params, batch, cache)
    logits, cache = model.prefill_chunked(params, batch, cache, chunk)
    logits, cache = model.decode_step(params, tok, pos, cache)

The reference's stacked-layer ``lax.scan`` becomes a loop over per-layer
parameter dicts.  A period-1 stack keeps them in ``layers`` and its cache in
the reference's stacked (L, B, W, G, D) layout.  A local:global stack
(``cfg.attn.global_every`` = period > 1, gemma3's 5:1) has ``n_groups`` groups
of ``period - 1`` local layers, which attend within ``LOCAL_WINDOW`` tokens,
and one global layer: ``layers_loc`` is a list of ``n_groups`` lists of
``period - 1`` dicts, ``layers_glob`` a list of ``n_groups`` dicts, and the
cache holds a ring of min(LOCAL_WINDOW, cache_len) slots for the local layers
(``loc_k``/``loc_v`` (n_groups, period-1, B, Wl, G, D), ``loc_pos`` (B, Wl))
and a full buffer for the global ones (``glob_k``/``glob_v`` (n_groups, B,
cache_len, G, D), ``glob_pos``).  ``cfg.remat`` (the reference's
``jax.checkpoint`` around the scan body) checkpoints each layer of
``train_logits`` with ``torch.utils.checkpoint``.  An MoE stack
(``cfg.family == "moe"``: deepseek-moe-16b, qwen3-moe-235b-a22b) has a
``moe`` subtree (router, experts, shared experts) in place of each layer's
``mlp``; its blocks return the layer's load-balance aux loss, which
``train_logits`` sums over the layers and divides by ``n_layers``, and which
prefill and decode drop.  All nonlinearities route through ``cfg.approx``
(the paper's table backend).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device

from .attention import (
    attention_out,
    cache_insert,
    flash_attention,
    init_attention,
    project_qkv,
)
from .common import (
    embed,
    init_embedding,
    init_rmsnorm,
    rmsnorm,
    softcap,
    unembed,
)
from .config import DENSE, MOE, ArchConfig
from .mlp import glu, init_glu, init_mlp, init_moe, mlp, moe

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

AUX_WEIGHT = 0.01  # MoE load-balance loss weight (0 aux for dense stacks)
# sliding window of 'local' layers in a local:global pattern (read at call time)
LOCAL_WINDOW = 1024


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over targets >= 0 (-1 = ignore).  logits f32 (B, S, V).

    The gold logit is taken by a masked reduction over the vocab axis (the
    reference's one-hot form), not a gather."""
    mask = (targets >= 0).to(torch.float32)
    tgt = torch.clamp(targets, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    onehot = torch.arange(logits.shape[-1], device=logits.device) == tgt[..., None]
    gold = torch.where(onehot, logits, 0.0).sum(dim=-1)
    return ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _decode_positions(pos: torch.Tensor, pos_buf: torch.Tensor, W: int):
    """Normalize a decode position operand against a per-slot (B, W) buffer.

    ``pos`` is a () scalar (shared clock) or a (B,) vector (per-slot clocks).
    Returns ``(positions, pos_buf)``: positions (1,) or (B, 1), and a NEW
    pos_buf with this step's entries marked valid."""
    pos32 = pos.to(torch.int32)
    if pos.dim() == 0:
        pb = pos_buf.clone()
        pb[:, pos32 % W] = pos32
        return pos32[None], pb
    b = torch.arange(pos.shape[0], device=pos.device)
    return pos32[:, None], pos_buf.index_put((b, (pos32 % W).long()), pos32)


class DecoderLM:
    def __init__(self, cfg: ArchConfig, device: DeviceLike = None):
        if cfg.family not in (DENSE, MOE):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: ROADMAP queue 1, "
                "items 11d-f (remaining model families)")
        self.period = max(1, cfg.attn.global_every)
        if cfg.n_layers % self.period:
            raise ValueError("n_layers must be divisible by the local:global period")
        self.n_groups = cfg.n_layers // self.period
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.compute_dtype]
        self.act = cfg.approx.unary(cfg.act, self.device)
        self._cap_tanh = None
        if cfg.attn.logit_softcap > 0:
            self._cap_tanh = cfg.approx.unary("tanh", self.device)
        self.rope_sin_cos = cfg.approx.rope_sin_cos(self.device)
        # TableFlash: flash attention's softmax exponent through the pack's
        # exp_neg member when attn_table is on (None = exact exp)
        self.attn_exp = cfg.approx.attn_exp(self.device)

    # ------------------------------- init ----------------------------------------

    def _init_layer(self, gen: torch.Generator) -> Params:
        cfg, dt = self.cfg, torch.float32
        p = {
            "ln1": init_rmsnorm(cfg.d_model, self.device, dt),
            "attn": init_attention(gen, cfg.d_model, cfg.attn_geom,
                                   qk_norm=cfg.attn.qk_norm, dtype=dt),
            "ln2": init_rmsnorm(cfg.d_model, self.device, dt),
        }
        if cfg.family == MOE:
            p["moe"] = init_moe(gen, cfg.d_model, cfg.d_ff, cfg.moe.n_experts,
                                cfg.moe.n_shared, dt)
        elif cfg.mlp_kind == "glu":
            p["mlp"] = init_glu(gen, cfg.d_model, cfg.d_ff, dt)
        else:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dt)
        return p

    def init(self, gen: torch.Generator) -> Params:
        """Random parameters drawn from ``gen`` (a generator on the model's
        device), every leaf f32 whatever ``cfg.param_dtype`` says: the
        reference's ``init`` never reads that field, and the trainer scales
        and sums the grads in the leaves' dtype."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on {self.device}")
        cfg = self.cfg
        params: Params = {
            "embed": init_embedding(gen, cfg.vocab_pad, cfg.d_model, torch.float32),
            "final_norm": init_rmsnorm(cfg.d_model, self.device, torch.float32),
        }
        if self.period == 1:
            params["layers"] = [self._init_layer(gen) for _ in range(cfg.n_layers)]
        else:  # the reference's order: every local layer, then the global ones
            n_loc = self.period - 1
            loc = [self._init_layer(gen) for _ in range(self.n_groups * n_loc)]
            params["layers_loc"] = [loc[g * n_loc:(g + 1) * n_loc]
                                    for g in range(self.n_groups)]
            params["layers_glob"] = [self._init_layer(gen)
                                     for _ in range(self.n_groups)]
        if not cfg.tie_embeddings:
            params["unembed"] = init_embedding(gen, cfg.vocab_pad, cfg.d_model,
                                               torch.float32)
        return params

    # ------------------------------ blocks -----------------------------------------

    def _logits(self, params, x):
        x = rmsnorm(params["final_norm"], x)
        logits = unembed(params.get("unembed", params["embed"]), x)
        logits = softcap(logits, self.cfg.attn.logit_softcap, self._cap_tanh)
        if self.cfg.vocab_pad != self.cfg.vocab:  # mask padded vocab rows
            iota = torch.arange(logits.shape[-1], device=logits.device)
            logits = torch.where(iota < self.cfg.vocab, logits, -1e30)
        return logits

    def _ffn(self, lp, x):
        """The feed-forward half: (x + ffn(x), the layer's aux loss, None for
        a dense layer)."""
        cfg = self.cfg
        hin = rmsnorm(lp["ln2"], x)
        if cfg.family == MOE:
            ff, aux = moe(lp["moe"], hin, self.act, top_k=cfg.moe.top_k,
                          capacity_factor=cfg.moe.capacity_factor,
                          device_groups=cfg.moe.device_groups,
                          max_groups=cfg.moe.max_groups)
            return x + ff, aux
        if cfg.mlp_kind == "glu":
            return x + glu(lp["mlp"], hin, self.act), None
        return x + mlp(lp["mlp"], hin, self.act), None

    def _qkv(self, lp, x, positions):
        cfg = self.cfg
        return project_qkv(lp["attn"], rmsnorm(lp["ln1"], x), positions,
                           geom=cfg.attn_geom, rope_theta=cfg.attn.rope_theta,
                           rope_sin_cos=self.rope_sin_cos)

    def _self_block(self, lp, x, positions, window):
        """Train/prefill block: attend within x.  Returns (x, (k, v), aux)."""
        cfg = self.cfg
        q, k, v = self._qkv(lp, x, positions)
        o = flash_attention(q, k, v, positions, positions, causal=True,
                            window=window, exp_fn=self.attn_exp)
        x = x + attention_out(lp["attn"], o, cfg.attn_geom)
        x, aux = self._ffn(lp, x)
        return x, (k, v), aux

    def _decode_block(self, lp, x, positions, window, kb, vb, pb_new):
        """Decode block: project the new tokens, insert, attend over the buffer."""
        cfg = self.cfg
        q, k, v = self._qkv(lp, x, positions)
        kb, vb, _ = cache_insert(kb, vb, pb_new, k, v, positions)
        o = flash_attention(q, kb, vb, positions, pb_new, causal=True,
                            window=window, exp_fn=self.attn_exp)
        x = x + attention_out(lp["attn"], o, cfg.attn_geom)
        return self._ffn(lp, x)[0], kb, vb

    def _window_of(self, idx_in_period):
        if self.period == 1:
            return self.cfg.attn.window
        return LOCAL_WINDOW if idx_in_period < self.period - 1 else 0

    def _stack(self, params):
        """Every layer in order, as (layer params, window, cache prefix, cache
        index): prefix "" with index i for a period-1 stack, "loc_" with (g, i)
        for a local layer, "glob_" with g for a global one."""
        if self.period == 1:
            w = self._window_of(0)
            return [(lp, w, "", i) for i, lp in enumerate(params["layers"])]
        out = []
        for g in range(self.n_groups):
            for i, lp in enumerate(params["layers_loc"][g]):
                out.append((lp, self._window_of(i), "loc_", (g, i)))
            out.append((params["layers_glob"][g], self._window_of(self.period - 1),
                        "glob_", g))
        return out

    # ------------------------------- train -----------------------------------------

    def train_logits(self, params, batch):
        """batch["tokens"]: (B, S) integer tensor.  Returns the (B, S, V) f32
        logits and the aux loss: the layers' sum over ``n_layers`` (0 for a
        dense stack)."""
        tokens = batch["tokens"]
        x = embed(params["embed"], tokens, self.dtype)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def block(lp, h, w):
            h, _, a = self._self_block(lp, h, positions, w)
            return h, a

        for lp, window, _, _ in self._stack(params):
            if self.cfg.remat:
                x, a = checkpoint(block, lp, x, window, use_reentrant=False)
            else:
                x, a = block(lp, x, window)
            if a is not None:
                aux = aux + a
        return self._logits(params, x), aux / self.cfg.n_layers

    def loss(self, params, batch):
        logits, aux = self.train_logits(params, batch)
        return cross_entropy(logits, batch["targets"]) + AUX_WEIGHT * aux

    # ------------------------------- cache ------------------------------------------

    def init_cache(self, batch: int, cache_len: int, device: DeviceLike = None) -> Cache:
        """bf16 k/v buffers and per-slot (B, W) int32 positions (-1 = empty),
        so a freed slot can be refilled mid-stream: (L, B, W, G, D) for a
        period-1 stack, the local rings and global buffers of the module
        docstring for a local:global one.  ``device`` defaults to the model's
        (``"meta"`` gives shapes only)."""
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        G, D = cfg.attn_geom.g_eff, cfg.head_dim
        mk = lambda *s: torch.zeros(s, dtype=torch.bfloat16, device=dev)
        pos = lambda W: torch.full((batch, W), -1, dtype=torch.int32, device=dev)
        if self.period == 1:
            W = cache_len if cfg.attn.window == 0 else min(cfg.attn.window, cache_len)
            return {"k": mk(cfg.n_layers, batch, W, G, D),
                    "v": mk(cfg.n_layers, batch, W, G, D), "pos": pos(W)}
        Wl = min(LOCAL_WINDOW, cache_len)
        n_loc = self.period - 1
        return {"loc_k": mk(self.n_groups, n_loc, batch, Wl, G, D),
                "loc_v": mk(self.n_groups, n_loc, batch, Wl, G, D),
                "loc_pos": pos(Wl),
                "glob_k": mk(self.n_groups, batch, cache_len, G, D),
                "glob_v": mk(self.n_groups, batch, cache_len, G, D),
                "glob_pos": pos(cache_len)}

    @staticmethod
    def _ring_window(k_new, v_new, positions, W):
        S = k_new.shape[1]
        if S >= W:  # only the last W tokens can survive a ring overwrite
            return k_new[:, -W:], v_new[:, -W:], positions[-W:]
        return k_new, v_new, positions

    @staticmethod
    def _stacked(cache, bufs):
        """The per-layer buffers ``bufs`` (name -> list in layer order) stacked
        into ``cache``'s layout."""
        return {n: torch.stack(b).reshape(cache[n].shape) for n, b in bufs.items()}

    # --------------------------- prefill / decode ------------------------------------

    def prefill(self, params, batch, cache):
        """batch["tokens"]: (B, S) integer tensor.  Returns the last
        position's logits (B, V) and a new cache."""
        tokens = batch["tokens"]
        x = embed(params["embed"], tokens, self.dtype)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        bufs = {n: [] for n in cache if not n.endswith("pos")}
        pbs = {}
        for lp, window, pre, idx in self._stack(params):
            x, (k, v), _ = self._self_block(lp, x, positions, window)
            kn, vn, pn = self._ring_window(k, v, positions, cache[pre + "pos"].shape[1])
            kb, vb, pbs[pre + "pos"] = cache_insert(
                cache[pre + "k"][idx], cache[pre + "v"][idx], cache[pre + "pos"],
                kn, vn, pn)
            bufs[pre + "k"].append(kb)
            bufs[pre + "v"].append(vb)
        return self._logits(params, x[:, -1:])[:, 0], {**self._stacked(cache, bufs),
                                                       **pbs}

    def _decode_stack(self, params, x, positions, pbs, cache):
        """Every layer's decode block over x at ``positions``, with the
        position buffers ``pbs`` (name -> this step's buffer).  Returns x and
        the new cache."""
        bufs = {n: [] for n in cache if not n.endswith("pos")}
        for lp, window, pre, idx in self._stack(params):
            x, kb, vb = self._decode_block(lp, x, positions, window,
                                           cache[pre + "k"][idx],
                                           cache[pre + "v"][idx], pbs[pre + "pos"])
            bufs[pre + "k"].append(kb)
            bufs[pre + "v"].append(vb)
        return x, {**self._stacked(cache, bufs), **pbs}

    def prefill_chunked(self, params, batch, cache, chunk: int = 4096):
        """Deployment prefill for long prompts: feed ``chunk`` tokens at a
        time through the decode path (insert the chunk's k/v, attend to
        cache + self), so peak activation memory is O(chunk) instead of O(S).
        Equivalent to ``prefill``; single-period stacks only, as in the
        reference."""
        tokens = batch["tokens"]
        if self.period != 1:
            raise NotImplementedError("chunked prefill: single-period stacks only")
        logits = None
        for start in range(0, tokens.shape[1], chunk):
            tok_c = tokens[:, start:start + chunk]
            pos_c = torch.arange(start, start + tok_c.shape[1], device=tokens.device)
            logits, cache = self._prefill_chunk_step(params, tok_c, pos_c, cache)
        return logits, cache

    def _prefill_chunk_step(self, params, tok_c, positions, cache):
        x = embed(params["embed"], tok_c, self.dtype)
        pb = cache["pos"].clone()
        pb[:, positions % pb.shape[1]] = positions.to(torch.int32)
        x, new_cache = self._decode_stack(params, x, positions, {"pos": pb}, cache)
        return self._logits(params, x[:, -1:])[:, 0], new_cache

    def decode_step(self, params, tok, pos, cache):
        """tok: (B, 1) integer tensor; pos: () shared absolute position, or
        (B,) per-slot positions (continuous batching)."""
        x = embed(params["embed"], tok, self.dtype)
        pbs = {}
        for name in cache:
            if name.endswith("pos"):  # one clock, each buffer modulo its width
                positions, pbs[name] = _decode_positions(pos, cache[name],
                                                         cache[name].shape[1])
        x, new_cache = self._decode_stack(params, x, positions, pbs, cache)
        return self._logits(params, x)[:, 0], new_cache
