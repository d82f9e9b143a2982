"""DecoderLM — the dense GQA transformer behind one API (the JAX package's
``models/transformer.py::DecoderLM`` for a period-1 stack):

    model = build_model(cfg, device=...)          # repro_torch.models.registry
    params = model.init(generator)
    logits, aux = model.train_logits(params, batch)
    loss = model.loss(params, batch)
    cache = model.init_cache(batch_size, cache_len)
    logits, cache = model.prefill(params, batch, cache)
    logits, cache = model.decode_step(params, tok, pos, cache)

The stacked-layer ``lax.scan`` becomes a loop over a list of per-layer
parameter dicts; the cache keeps the reference's stacked (L, B, W, G, D)
layout.  ``cfg.remat`` (the reference's ``jax.checkpoint`` around the scan
body) checkpoints each layer of ``train_logits`` with
``torch.utils.checkpoint``.  All nonlinearities route through ``cfg.approx``
(the paper's table backend).  MoE and local:global stacks come with ROADMAP
queue 1, item 11.
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
from .config import DENSE, ArchConfig
from .mlp import glu, init_glu, init_mlp, mlp

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

AUX_WEIGHT = 0.01  # MoE load-balance loss weight (0 aux for dense stacks)


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
        if cfg.family != DENSE:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: ROADMAP queue 1, "
                "item 11 (remaining model families)")
        if max(1, cfg.attn.global_every) != 1:
            raise NotImplementedError(
                "local:global layer stacks are not ported yet: ROADMAP queue 1, "
                "item 11 (gemma3)")
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
        if cfg.mlp_kind == "glu":
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
            "layers": [self._init_layer(gen) for _ in range(cfg.n_layers)],
        }
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
        hin = rmsnorm(lp["ln2"], x)
        if self.cfg.mlp_kind == "glu":
            return x + glu(lp["mlp"], hin, self.act)
        return x + mlp(lp["mlp"], hin, self.act)

    def _qkv(self, lp, x, positions):
        cfg = self.cfg
        return project_qkv(lp["attn"], rmsnorm(lp["ln1"], x), positions,
                           geom=cfg.attn_geom, rope_theta=cfg.attn.rope_theta,
                           rope_sin_cos=self.rope_sin_cos)

    def _self_block(self, lp, x, positions):
        """Prefill block: attend within x.  Returns (x, (k, v))."""
        cfg = self.cfg
        q, k, v = self._qkv(lp, x, positions)
        o = flash_attention(q, k, v, positions, positions, causal=True,
                            window=cfg.attn.window, exp_fn=self.attn_exp)
        x = x + attention_out(lp["attn"], o, cfg.attn_geom)
        return self._ffn(lp, x), (k, v)

    def _decode_block(self, lp, x, positions, kb, vb, pb_new):
        """Decode block: project 1 token, insert, attend over the buffer."""
        cfg = self.cfg
        q, k, v = self._qkv(lp, x, positions)
        kb, vb, _ = cache_insert(kb, vb, pb_new, k, v, positions)
        o = flash_attention(q, kb, vb, positions, pb_new, causal=True,
                            window=cfg.attn.window, exp_fn=self.attn_exp)
        x = x + attention_out(lp["attn"], o, cfg.attn_geom)
        return self._ffn(lp, x), kb, vb

    # ------------------------------- train -----------------------------------------

    def train_logits(self, params, batch):
        """batch["tokens"]: (B, S) integer tensor.  Returns the (B, S, V) f32
        logits and the aux loss (0 for a dense stack)."""
        tokens = batch["tokens"]
        x = embed(params["embed"], tokens, self.dtype)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        block = lambda lp, h: self._self_block(lp, h, positions)[0]
        for lp in params["layers"]:
            if self.cfg.remat:
                x = checkpoint(block, lp, x, use_reentrant=False)
            else:
                x = block(lp, x)
        return self._logits(params, x), torch.zeros((), dtype=torch.float32,
                                                    device=x.device)

    def loss(self, params, batch):
        logits, aux = self.train_logits(params, batch)
        return cross_entropy(logits, batch["targets"]) + AUX_WEIGHT * aux

    # ------------------------------- cache ------------------------------------------

    def init_cache(self, batch: int, cache_len: int, device: DeviceLike = None) -> Cache:
        """bf16 k/v (L, B, W, G, D) and per-slot (B, W) int32 positions
        (-1 = empty), so a freed slot can be refilled mid-stream.
        ``device`` defaults to the model's (``"meta"`` gives shapes only)."""
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        G, D = cfg.attn_geom.g_eff, cfg.head_dim
        W = cache_len if cfg.attn.window == 0 else min(cfg.attn.window, cache_len)
        shape = (cfg.n_layers, batch, W, G, D)
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                "pos": torch.full((batch, W), -1, dtype=torch.int32, device=dev)}

    @staticmethod
    def _ring_window(k_new, v_new, positions, W):
        S = k_new.shape[1]
        if S >= W:  # only the last W tokens can survive a ring overwrite
            return k_new[:, -W:], v_new[:, -W:], positions[-W:]
        return k_new, v_new, positions

    # --------------------------- prefill / decode ------------------------------------

    def prefill(self, params, batch, cache):
        """batch["tokens"]: (B, S) integer tensor.  Returns the last
        position's logits (B, V) and a new cache."""
        tokens = batch["tokens"]
        S = tokens.shape[1]
        x = embed(params["embed"], tokens, self.dtype)
        positions = torch.arange(S, device=tokens.device)
        W = cache["k"].shape[2]
        ks, vs = [], []
        pb = cache["pos"]
        for i, lp in enumerate(params["layers"]):
            x, (k, v) = self._self_block(lp, x, positions)
            kn, vn, pn = self._ring_window(k, v, positions, W)
            kb, vb, pb = cache_insert(cache["k"][i], cache["v"][i], cache["pos"],
                                      kn, vn, pn)
            ks.append(kb)
            vs.append(vb)
        new_cache = {"k": torch.stack(ks), "v": torch.stack(vs), "pos": pb}
        return self._logits(params, x[:, -1:])[:, 0], new_cache

    def decode_step(self, params, tok, pos, cache):
        """tok: (B, 1) integer tensor; pos: () shared absolute position, or
        (B,) per-slot positions (continuous batching)."""
        x = embed(params["embed"], tok, self.dtype)
        W = cache["k"].shape[2]
        positions, pb = _decode_positions(pos, cache["pos"], W)
        ks, vs = [], []
        for i, lp in enumerate(params["layers"]):
            x, kb, vb = self._decode_block(lp, x, positions, cache["k"][i],
                                           cache["v"][i], pb)
            ks.append(kb)
            vs.append(vb)
        new_cache = {"k": torch.stack(ks), "v": torch.stack(vs), "pos": pb}
        return self._logits(params, x)[:, 0], new_cache
