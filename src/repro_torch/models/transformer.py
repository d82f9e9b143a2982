"""The port's model families behind one API (the JAX package's
``models/transformer.py``):

    model = build_model(cfg, device=...)          # repro_torch.models.registry
    params = model.init(generator)
    logits, aux = model.train_logits(params, batch)
    loss = model.loss(params, batch)
    cache = model.init_cache(batch_size, cache_len)
    logits, cache = model.prefill(params, batch, cache)
    logits, cache = model.prefill_chunked(params, batch, cache, chunk)  # DecoderLM
    logits, cache = model.decode_step(params, tok, pos, cache)

Families: ``DecoderLM`` (dense and MoE GQA transformers, period-1 and
local:global stacks), ``HybridLM`` (zamba2's Mamba2 stack with one shared
attention+MLP block every k layers), ``XLSTMLM`` (alternating mLSTM /
sLSTM blocks), ``EncDecLM`` (whisper's encoder over stub frame embeddings
and a decoder that cross-attends to it) and ``VLM`` (stub patch embeddings
projected before a ``DecoderLM`` backbone's tokens); the last two read
``batch["frames"]`` / ``batch["patches"]`` besides the tokens
(``extra_inputs``).  ``BaseLM`` holds what they share: the approx closures, the
loss and the logits head.

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
``train_logits`` with ``torch.utils.checkpoint`` (a hybrid group and each
trailing layer; an xLSTM pair).  An MoE stack
(``cfg.family == "moe"``: deepseek-moe-16b, qwen3-moe-235b-a22b) has a
``moe`` subtree (router, experts, shared experts) in place of each layer's
``mlp``; its blocks return the layer's load-balance aux loss, which
``train_logits`` sums over the layers and divides by ``n_layers``, and which
prefill and decode drop.  The recurrent families' caches are flat dicts with
one stacked tensor a state field, each with one batch axis (the engine's
slot refill moves rows along it; see ``HybridLM`` and ``XLSTMLM``).  All
nonlinearities route through ``cfg.approx`` (the paper's table backend).

On a mesh (``repro_torch.parallel.sharding.use_sharding``; the dense family's
training, ``train.loop.run(mesh=...)``) the parameters and the batch are
DTensors: ``shard`` (``shard_activation``) lays the activations out by the
reference's logical axes at the reference's places, the projections and the
embedding run on local shards (``sharding.einsum``, ``vocab_lookup``), and so
do rotary, flash attention and the pack closures, which are local to a
position and a head; off a mesh every annotation is the identity.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.sharding import (is_dtensor, on_local_shards, replicate_like,
                                           unary_on)
from repro_torch.parallel.sharding import shard_activation as shard

from .attention import (
    attention_out,
    cache_insert,
    flash_attention,
    init_attention,
    project_kv,
    project_qkv,
)
from .common import (
    embed,
    init_embedding,
    init_linear,
    init_rmsnorm,
    linear,
    rmsnorm,
    sinusoidal_positions,
    softcap,
    unembed,
)
from .config import DENSE, MOE, VLM as VLM_FAM, ArchConfig
from .mlp import glu, init_glu, init_mlp, init_moe, mlp, moe
from .ssm import SSMCache, init_mamba2, init_ssm_cache, mamba2_block
from .xlstm import (MLSTMCache, SLSTMCache, init_mlstm, init_mlstm_cache, init_slstm,
                    init_slstm_cache, mlstm_block, slstm_block)

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

AUX_WEIGHT = 0.01  # MoE load-balance loss weight (0 aux for dense stacks)
# sliding window of 'local' layers in a local:global pattern (read at call time)
LOCAL_WINDOW = 1024


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over targets >= 0 (-1 = ignore).  logits f32 (B, S, V).

    The gold logit is taken by a masked reduction over the vocab axis (the
    reference's one-hot form), not a gather.  DTensor logits (a mesh): the
    row's terms on the local shards, summed over the mesh."""
    if is_dtensor(logits):
        return _mesh_cross_entropy(logits, targets)
    terms, mask = _ce_terms(logits, targets)
    return terms.sum() / torch.clamp(mask.sum(), min=1.0)


def _ce_terms(logits: torch.Tensor, targets: torch.Tensor):
    """Each position's masked loss and its mask (f32, the targets' shape)."""
    mask = (targets >= 0).to(torch.float32)
    tgt = torch.clamp(targets, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    onehot = torch.arange(logits.shape[-1], device=logits.device) == tgt[..., None]
    gold = torch.where(onehot, logits, 0.0).sum(dim=-1)
    return (logz - gold) * mask, mask


def _mesh_cross_entropy(logits, targets) -> torch.Tensor:
    """:func:`cross_entropy` of DTensor logits and targets: a plain scalar,
    the same on every rank."""
    from torch.distributed.tensor import Replicate

    mesh, last = logits.device_mesh, logits.ndim - 1
    # logsumexp and the one-hot gold read the whole vocab row: gather it
    pl = [Replicate() if p.is_partial() or (p.is_shard() and p.dim == last) else p
          for p in logits.placements]
    logits = logits.redistribute(mesh, pl)
    targets = targets.redistribute(mesh, [Replicate() if p.is_partial() else p
                                          for p in pl])
    tp = tuple(targets.placements)
    terms, mask = on_local_shards(_ce_terms, (tp, tp), logits, targets)
    return terms.sum().full_tensor() / torch.clamp(mask.sum().full_tensor(), min=1.0)


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


class BaseLM:
    """What the families share: the compute dtype, the approx closures (the
    gate, the softcap tanh, table-served RoPE and TableFlash's exponent, on
    the model's device), the loss and the logits head."""

    # the batch entries besides tokens that ``prefill`` reads (the engines'
    # ``extra_inputs``): none for a decoder-only family
    extra_inputs: tuple = ()

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None):
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

    def _check_gen(self, gen: torch.Generator) -> None:
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on {self.device}")

    def abstract_params(self) -> Params:
        """The parameter tree as ``"meta"`` tensors, shapes and dtypes only
        (the reference's ``abstract_params``): ``init`` traced under a fake
        tensor mode, so nothing is drawn or allocated."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        from repro_torch.tree import tree_map

        dev, self.device = self.device, torch.device("cpu")
        try:
            with FakeTensorMode():
                params = self.init(torch.Generator())
        finally:
            self.device = dev
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                        params)

    def loss(self, params, batch):
        logits, aux = self.train_logits(params, batch)
        return cross_entropy(logits, batch["targets"]) + AUX_WEIGHT * aux

    def _logits(self, params, x):
        x = rmsnorm(params["final_norm"], x)
        logits = unembed(params.get("unembed", params["embed"]), x)
        cap_tanh = None if self._cap_tanh is None else unary_on(self._cap_tanh, logits)
        logits = softcap(logits, self.cfg.attn.logit_softcap, cap_tanh)
        if self.cfg.vocab_pad != self.cfg.vocab:  # mask padded vocab rows
            iota = replicate_like(torch.arange(logits.shape[-1], device=logits.device),
                                  logits)
            logits = torch.where(iota < self.cfg.vocab, logits, -1e30)
        return shard(logits, "batch", None, "vocab")


class DecoderLM(BaseLM):
    def __init__(self, cfg: ArchConfig, device: DeviceLike = None):
        if cfg.family not in (DENSE, MOE, VLM_FAM):  # a VLM's backbone is one
            raise ValueError(f"family {cfg.family!r} is not a decoder stack; "
                             "build_model builds its model")
        self.period = max(1, cfg.attn.global_every)
        if cfg.n_layers % self.period:
            raise ValueError("n_layers must be divisible by the local:global period")
        self.n_groups = cfg.n_layers // self.period
        super().__init__(cfg, device)

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
        self._check_gen(gen)
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
            return x + shard(ff, "batch", None, None), aux
        act = unary_on(self.act, hin)
        ff = glu(lp["mlp"], hin, act) if cfg.mlp_kind == "glu" else mlp(lp["mlp"], hin, act)
        return x + shard(ff, "batch", None, None), None

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
        x = x + shard(attention_out(lp["attn"], o, cfg.attn_geom), "batch", None, None)
        x, aux = self._ffn(lp, x)
        return x, (k, v), aux

    def _decode_block(self, lp, x, positions, window, kb, vb, pb_new):
        """Decode block: project the new tokens, insert, attend over the buffer."""
        cfg = self.cfg
        q, k, v = self._qkv(lp, x, positions)
        kb, vb, _ = cache_insert(kb, vb, pb_new, k, v, positions)
        o = flash_attention(q, kb, vb, positions, pb_new, causal=True,
                            window=window, exp_fn=self.attn_exp)
        x = x + shard(attention_out(lp["attn"], o, cfg.attn_geom), "batch", None, None)
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
        x = shard(embed(params["embed"], tokens, self.dtype), "batch", None, None)
        x, aux = self._train_stack(params, x)
        return self._logits(params, x), aux / self.cfg.n_layers

    def _train_stack(self, params, x):
        """Every layer over the embedded sequence x (B, S, d) at positions
        0..S-1: x and the layers' summed aux loss."""
        positions = torch.arange(x.shape[1], device=x.device)
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
        return x, aux

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
        x = shard(embed(params["embed"], batch["tokens"], self.dtype), "batch", None, None)
        x, cache = self._prefill_stack(params, x, cache)
        return self._logits(params, x[:, -1:])[:, 0], cache

    def _prefill_stack(self, params, x, cache):
        """Every layer over the embedded prompt x (B, S, d) at positions
        0..S-1, each layer's k/v inserted into the cache: x and the new
        cache."""
        positions = torch.arange(x.shape[1], device=x.device)
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
        return x, {**self._stacked(cache, bufs), **pbs}

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
        x = shard(embed(params["embed"], tok_c, self.dtype), "batch", None, None)
        pb = cache["pos"].clone()
        pb[:, positions % pb.shape[1]] = positions.to(torch.int32)
        x, new_cache = self._decode_stack(params, x, positions, {"pos": pb}, cache)
        return self._logits(params, x[:, -1:])[:, 0], new_cache

    def decode_step(self, params, tok, pos, cache):
        """tok: (B, 1) integer tensor; pos: () shared absolute position, or
        (B,) per-slot positions (continuous batching)."""
        x = shard(embed(params["embed"], tok, self.dtype), "batch", None, None)
        pbs = {}
        for name in cache:
            if name.endswith("pos"):  # one clock, each buffer modulo its width
                positions, pbs[name] = _decode_positions(pos, cache[name],
                                                         cache[name].shape[1])
        x, new_cache = self._decode_stack(params, x, positions, pbs, cache)
        return self._logits(params, x)[:, 0], new_cache


# ======================================================================================
# HybridLM — Mamba2 + shared attention block (zamba2)
# ======================================================================================


def _stacked_states(states, prefix: str, fields) -> Cache:
    """A nested list of state NamedTuples (any depth, batch axis innermost)
    as one flat cache entry a field: ``prefix + field`` -> stacked tensor."""
    def stack(t, f):
        if isinstance(t, list):
            return torch.stack([stack(u, f) for u in t])
        return getattr(t, f)
    return {prefix + f: stack(states, f) for f in fields}


class HybridLM(BaseLM):
    """``shared_attn_every`` Mamba2 layers a group, then ONE shared
    (weight-tied) attention+MLP block; trailing Mamba2 layers take the
    remainder (zamba2-1.2b: 6 groups of 6, and 2).

    Parameters: ``mamba`` a list of ``n_groups`` lists of ``per_group``
    layer dicts (``ln``, ``m``), ``mamba_tail`` a list of the trailing
    layers, ``shared`` the one attention+GLU block.  The cache is a flat
    dict: ``mamba_state`` (n_groups, per_group, B, H, P, N) f32 and
    ``mamba_conv_x``/``_b``/``_c`` (n_groups, per_group, B, K-1, C) f32, the
    same fields under ``mamba_tail_`` with a (trailing,) stack axis, and the
    shared block's ``attn_k``/``attn_v`` (n_groups, B, W, G, D) bf16 and
    ``attn_pos`` (B, W).  ``cfg.remat`` checkpoints each group (its Mamba2
    layers and the shared block's use) and each trailing layer, as the
    reference's ``jax.checkpoint`` does; the shared block's gradient sums
    over its uses."""

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None):
        super().__init__(cfg, device)
        self.act_softplus = cfg.approx.unary("softplus", self.device)
        k = cfg.shared_attn_every or cfg.n_layers
        self.n_groups = cfg.n_layers // k
        self.per_group = k
        self.trailing = cfg.n_layers - self.n_groups * k
        self.inner = cfg.ssm.expand * cfg.d_model

    # ------------------------------- init ----------------------------------------

    def _init_mamba(self, gen: torch.Generator) -> Params:
        s, d = self.cfg.ssm, self.cfg.d_model
        return {"ln": init_rmsnorm(d, self.device),
                "m": init_mamba2(gen, d, expand=s.expand, head_dim=s.head_dim,
                                 state_dim=s.state_dim, conv_width=s.conv_width)}

    def init(self, gen: torch.Generator) -> Params:
        """Random f32 parameters drawn from ``gen`` (a generator on the
        model's device), in the reference's tree and scales."""
        self._check_gen(gen)
        cfg, dt = self.cfg, torch.float32
        params: Params = {
            "embed": init_embedding(gen, cfg.vocab_pad, cfg.d_model, dt),
            "mamba": [[self._init_mamba(gen) for _ in range(self.per_group)]
                      for _ in range(self.n_groups)],
            "shared": {
                "ln1": init_rmsnorm(cfg.d_model, self.device),
                "attn": init_attention(gen, cfg.d_model, cfg.attn_geom, dtype=dt),
                "ln2": init_rmsnorm(cfg.d_model, self.device),
                "mlp": init_glu(gen, cfg.d_model, cfg.d_ff, dt),
            },
            "final_norm": init_rmsnorm(cfg.d_model, self.device),
        }
        if self.trailing:
            params["mamba_tail"] = [self._init_mamba(gen) for _ in range(self.trailing)]
        if not cfg.tie_embeddings:
            params["unembed"] = init_embedding(gen, cfg.vocab_pad, cfg.d_model, dt)
        return params

    # ------------------------------ blocks -----------------------------------------

    def _mamba(self, lp, x, cache=None):
        s = self.cfg.ssm
        y, new_cache = mamba2_block(
            lp["m"], rmsnorm(lp["ln"], x), expand=s.expand, head_dim=s.head_dim,
            state_dim=s.state_dim, conv_width=s.conv_width, chunk=s.chunk,
            act_silu=self.act, act_softplus=self.act_softplus, cache=cache)
        return x + shard(y, "batch", None, None), new_cache

    def _shared(self, sp, x, positions, kb=None, vb=None, pb=None):
        """The shared block: attend within x (train/prefill, returning its
        k/v), or insert into the (kb, vb) buffers at ``positions`` and attend
        over them (decode, returning the new buffers)."""
        cfg = self.cfg
        q, k, v = project_qkv(sp["attn"], rmsnorm(sp["ln1"], x), positions,
                              geom=cfg.attn_geom, rope_theta=cfg.attn.rope_theta,
                              rope_sin_cos=self.rope_sin_cos)
        if kb is None:
            o = flash_attention(q, k, v, positions, positions, causal=True,
                                window=cfg.attn.window, exp_fn=self.attn_exp)
            new = (k, v)
        else:
            kb, vb, _ = cache_insert(kb, vb, pb, k, v, positions)
            o = flash_attention(q, kb, vb, positions, pb, causal=True,
                                window=cfg.attn.window, exp_fn=self.attn_exp)
            new = (kb, vb)
        x = x + shard(attention_out(sp["attn"], o, cfg.attn_geom), "batch", None, None)
        x = x + shard(glu(sp["mlp"], rmsnorm(sp["ln2"], x), self.act),
                      "batch", None, None)
        return x, new

    def _train_group(self, mps, sp, x, positions):
        for lp in mps:
            x, _ = self._mamba(lp, x)
        return self._shared(sp, x, positions)[0]

    def _train_tail(self, lp, x):
        return self._mamba(lp, x)[0]

    @staticmethod
    def _ssm_cache(cache, prefix, idx) -> SSMCache:
        return SSMCache(*(cache[prefix + f][idx] for f in SSMCache._fields))

    # ------------------------------- train -----------------------------------------

    def train_logits(self, params, batch):
        tokens = batch["tokens"]
        x = shard(embed(params["embed"], tokens, self.dtype), "batch", None, None)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        remat = self.cfg.remat
        for mps in params["mamba"]:
            if remat:
                x = checkpoint(self._train_group, mps, params["shared"], x, positions,
                               use_reentrant=False)
            else:
                x = self._train_group(mps, params["shared"], x, positions)
        for lp in params.get("mamba_tail", []):
            x = (checkpoint(self._train_tail, lp, x, use_reentrant=False) if remat
                 else self._train_tail(lp, x))
        return self._logits(params, x), torch.zeros((), dtype=torch.float32,
                                                    device=x.device)

    # ------------------------------- cache ------------------------------------------

    def init_cache(self, batch: int, cache_len: int, device: DeviceLike = None) -> Cache:
        """The flat cache of the class docstring, zero states and empty
        (-1) positions; ``device`` defaults to the model's (``"meta"`` gives
        shapes only)."""
        cfg, s = self.cfg, self.cfg.ssm
        dev = self.device if device is None else torch.device(device)
        W = cache_len if cfg.attn.window == 0 else min(cfg.attn.window, cache_len)
        one = init_ssm_cache(batch, self.inner, s.state_dim, s.head_dim, s.conv_width,
                             dev)
        c = {"mamba_" + f: getattr(one, f).expand(
            (self.n_groups, self.per_group) + getattr(one, f).shape).clone()
            for f in SSMCache._fields}
        kv = (self.n_groups, batch, W, cfg.attn_geom.g_eff, cfg.head_dim)
        c["attn_k"] = torch.zeros(kv, dtype=torch.bfloat16, device=dev)
        c["attn_v"] = torch.zeros(kv, dtype=torch.bfloat16, device=dev)
        c["attn_pos"] = torch.full((batch, W), -1, dtype=torch.int32, device=dev)
        if self.trailing:
            c.update({"mamba_tail_" + f: getattr(one, f).expand(
                (self.trailing,) + getattr(one, f).shape).clone()
                for f in SSMCache._fields})
        return c

    # --------------------------- prefill / decode ------------------------------------

    def _forward(self, params, x, positions, cache, decode: bool):
        """Every layer over x with the cache's states (prefill: the shared
        block attends within x and its k/v go into the ring; decode: it
        attends over the buffers, whose ``attn_pos`` the caller updated).
        Returns x and the new cache."""
        sp, new = params["shared"], dict(cache)
        states, ks, vs = [], [], []
        for g, mps in enumerate(params["mamba"]):
            group = []
            for i, lp in enumerate(mps):
                x, nc = self._mamba(lp, x, self._ssm_cache(cache, "mamba_", (g, i)))
                group.append(nc)
            states.append(group)
            kb, vb = cache["attn_k"][g], cache["attn_v"][g]
            if decode:
                x, (kb, vb) = self._shared(sp, x, positions, kb, vb, cache["attn_pos"])
            else:
                x, (k, v) = self._shared(sp, x, positions)
                kn, vn, pn = DecoderLM._ring_window(k, v, positions, kb.shape[1])
                kb, vb, new["attn_pos"] = cache_insert(kb, vb, cache["attn_pos"],
                                                       kn, vn, pn)
            ks.append(kb)
            vs.append(vb)
        new.update(_stacked_states(states, "mamba_", SSMCache._fields))
        new["attn_k"], new["attn_v"] = torch.stack(ks), torch.stack(vs)
        if self.trailing:
            tail = []
            for t, lp in enumerate(params["mamba_tail"]):
                x, nc = self._mamba(lp, x, self._ssm_cache(cache, "mamba_tail_", t))
                tail.append(nc)
            new.update(_stacked_states(tail, "mamba_tail_", SSMCache._fields))
        return x, new

    def prefill(self, params, batch, cache):
        """batch["tokens"]: (B, S).  Returns the last position's logits (B, V)
        and a new cache."""
        tokens = batch["tokens"]
        x = shard(embed(params["embed"], tokens, self.dtype), "batch", None, None)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x, cache = self._forward(params, x, positions, cache, decode=False)
        return self._logits(params, x[:, -1:])[:, 0], cache

    def decode_step(self, params, tok, pos, cache):
        """tok: (B, 1); pos: () shared absolute position, or (B,) per-slot
        positions (continuous batching) — the shared block's clock; the
        Mamba2 states carry no position."""
        x = shard(embed(params["embed"], tok, self.dtype), "batch", None, None)
        positions, pb = _decode_positions(pos, cache["attn_pos"],
                                          cache["attn_pos"].shape[1])
        x, cache = self._forward(params, x, positions, {**cache, "attn_pos": pb},
                                 decode=True)
        return self._logits(params, x)[:, 0], cache


# ======================================================================================
# XLSTMLM — alternating mLSTM / sLSTM
# ======================================================================================


class XLSTMLM(BaseLM):
    """``n_layers / 2`` pairs of an mLSTM and an sLSTM block, no attention and
    no positions.  Parameters: ``mlstm`` and ``slstm``, lists of ``n_pairs``
    block dicts (``ln``, ``b``).  The cache is a flat dict, each entry
    stacked over the pairs: the mLSTM's ``m_c`` (n_pairs, B, H, D, D),
    ``m_n`` (n_pairs, B, H, D) and ``m_m`` (n_pairs, B, H), the sLSTM's
    ``s_h``, ``s_c``, ``s_n``, ``s_m`` (n_pairs, B, d), all f32; the
    stabilizers start at -1e30.  ``cfg.remat`` checkpoints each pair."""

    M_FIELDS = {"m_" + f: f for f in MLSTMCache._fields}
    S_FIELDS = {"s_" + f: f for f in SLSTMCache._fields}

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None):
        if cfg.n_layers % 2:
            raise ValueError("xLSTM stack alternates mLSTM/sLSTM: need even layers")
        super().__init__(cfg, device)
        self.n_pairs = cfg.n_layers // 2
        self.act_sigmoid = cfg.approx.unary("sigmoid", self.device)
        self.act_tanh = cfg.approx.unary("tanh", self.device)
        self.act_exp = cfg.approx.unary("exp", self.device)  # exp_neg table domain

    def init(self, gen: torch.Generator) -> Params:
        """Random f32 parameters drawn from ``gen`` (a generator on the
        model's device), in the reference's tree and scales."""
        self._check_gen(gen)
        cfg, dt = self.cfg, torch.float32
        ln = lambda: init_rmsnorm(cfg.d_model, self.device)
        params: Params = {
            "embed": init_embedding(gen, cfg.vocab_pad, cfg.d_model, dt),
            "mlstm": [{"ln": ln(), "b": init_mlstm(gen, cfg.d_model, cfg.n_heads)}
                      for _ in range(self.n_pairs)],
            "slstm": [{"ln": ln(), "b": init_slstm(gen, cfg.d_model)}
                      for _ in range(self.n_pairs)],
            "final_norm": ln(),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = init_embedding(gen, cfg.vocab_pad, cfg.d_model, dt)
        return params

    def _pair(self, mp, sp, x, mcache=None, scache=None):
        y, new_m = mlstm_block(mp["b"], rmsnorm(mp["ln"], x), n_heads=self.cfg.n_heads,
                               act_sigmoid=self.act_sigmoid, act_exp=self.act_exp,
                               cache=mcache)
        x = x + shard(y, "batch", None, None)
        y, new_s = slstm_block(sp["b"], rmsnorm(sp["ln"], x),
                               act_sigmoid=self.act_sigmoid, act_tanh=self.act_tanh,
                               act_exp=self.act_exp, cache=scache)
        return x + shard(y, "batch", None, None), new_m, new_s

    def _train_pair(self, mp, sp, x):
        return self._pair(mp, sp, x)[0]

    def train_logits(self, params, batch):
        x = shard(embed(params["embed"], batch["tokens"], self.dtype), "batch", None, None)
        for mp, sp in zip(params["mlstm"], params["slstm"]):
            x = (checkpoint(self._train_pair, mp, sp, x, use_reentrant=False)
                 if self.cfg.remat else self._train_pair(mp, sp, x))
        return self._logits(params, x), torch.zeros((), dtype=torch.float32,
                                                    device=x.device)

    def init_cache(self, batch: int, cache_len: int, device: DeviceLike = None) -> Cache:
        """The flat cache of the class docstring (``cache_len`` is unused:
        the states have no positions); ``device`` defaults to the model's
        (``"meta"`` gives shapes only)."""
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        stack = lambda t: t.expand((self.n_pairs,) + t.shape).clone()
        mc = init_mlstm_cache(batch, cfg.d_model, cfg.n_heads, dev)
        sc = init_slstm_cache(batch, cfg.d_model, dev)
        return {**{k: stack(getattr(mc, f)) for k, f in self.M_FIELDS.items()},
                **{k: stack(getattr(sc, f)) for k, f in self.S_FIELDS.items()}}

    def _forward(self, params, x, cache):
        ms, ss = [], []
        for i, (mp, sp) in enumerate(zip(params["mlstm"], params["slstm"])):
            mc = MLSTMCache(*(cache[k][i] for k in self.M_FIELDS))
            sc = SLSTMCache(*(cache[k][i] for k in self.S_FIELDS))
            x, nm, ns = self._pair(mp, sp, x, mc, sc)
            ms.append(nm)
            ss.append(ns)
        return x, {**_stacked_states(ms, "m_", MLSTMCache._fields),
                   **_stacked_states(ss, "s_", SLSTMCache._fields)}

    def prefill(self, params, batch, cache):
        """batch["tokens"]: (B, S).  Returns the last position's logits (B, V)
        and a new cache."""
        x = shard(embed(params["embed"], batch["tokens"], self.dtype), "batch", None, None)
        x, cache = self._forward(params, x, cache)
        return self._logits(params, x[:, -1:])[:, 0], cache

    def decode_step(self, params, tok, pos, cache):
        """tok: (B, 1); ``pos`` is unused (the states carry no position)."""
        x = shard(embed(params["embed"], tok, self.dtype), "batch", None, None)
        x, cache = self._forward(params, x, cache)
        return self._logits(params, x)[:, 0], cache


# ======================================================================================
# EncDecLM — whisper-small (stub conv frontend)
# ======================================================================================


class EncDecLM(BaseLM):
    """Encoder: a bidirectional transformer over stub frame embeddings
    ``batch["frames"]`` (B, enc_len, d), with absolute sinusoidal positions
    and no RoPE.  Decoder: causal self-attention (cached) with RoPE, then
    cross-attention into the encoder memory, then the MLP.

    Parameters: ``enc_layers`` and ``dec_layers``, lists of layer dicts
    (``ln1``, ``attn``, ``ln2``, ``mlp``; ``ln1``, ``self``, ``lnx``,
    ``cross``, ``ln2``, ``mlp``), ``enc_norm``, and an untied ``unembed``
    whatever ``tie_embeddings`` says, as in the reference.  The cache is the
    period-1 decoder's (``k``/``v`` (L, B, W, G, D) bf16, ``pos`` (B, W))
    plus ``memory`` (B, enc_len, d) bf16, the encoder output rounded.
    ``prefill`` cross-attends to the unrounded encoder output, ``decode_step``
    to the bf16 ``memory``, whose k/v it projects again in every layer and
    step: the reference's numbers, not a cached k/v layout."""

    extra_inputs = ("frames",)

    # ------------------------------- init ----------------------------------------

    def _init_enc_layer(self, gen: torch.Generator) -> Params:
        cfg = self.cfg
        return {"ln1": init_rmsnorm(cfg.d_model, self.device),
                "attn": init_attention(gen, cfg.d_model, cfg.attn_geom),
                "ln2": init_rmsnorm(cfg.d_model, self.device),
                "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff)}

    def _init_dec_layer(self, gen: torch.Generator) -> Params:
        cfg = self.cfg
        return {"ln1": init_rmsnorm(cfg.d_model, self.device),
                "self": init_attention(gen, cfg.d_model, cfg.attn_geom),
                "lnx": init_rmsnorm(cfg.d_model, self.device),
                "cross": init_attention(gen, cfg.d_model, cfg.attn_geom),
                "ln2": init_rmsnorm(cfg.d_model, self.device),
                "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff)}

    def init(self, gen: torch.Generator) -> Params:
        """Random f32 parameters drawn from ``gen`` (a generator on the
        model's device), in the reference's tree and scales."""
        self._check_gen(gen)
        cfg = self.cfg
        return {
            "embed": init_embedding(gen, cfg.vocab_pad, cfg.d_model),
            "enc_layers": [self._init_enc_layer(gen) for _ in range(cfg.n_enc_layers)],
            "enc_norm": init_rmsnorm(cfg.d_model, self.device),
            "dec_layers": [self._init_dec_layer(gen) for _ in range(cfg.n_layers)],
            "final_norm": init_rmsnorm(cfg.d_model, self.device),
            "unembed": init_embedding(gen, cfg.vocab_pad, cfg.d_model),
        }

    # ------------------------------ blocks -----------------------------------------

    def _enc_block(self, lp, x, positions):
        cfg = self.cfg
        q, k, v = project_qkv(lp["attn"], rmsnorm(lp["ln1"], x), None,
                              geom=cfg.attn_geom, rope_theta=0.0)
        o = flash_attention(q, k, v, positions, positions, causal=False,
                            exp_fn=self.attn_exp)
        x = x + shard(attention_out(lp["attn"], o, cfg.attn_geom), "batch", None, None)
        return x + shard(mlp(lp["mlp"], rmsnorm(lp["ln2"], x), self.act),
                         "batch", None, None)

    def encode(self, params, frames):
        """frames (B, T, d) -> the encoder memory (B, T, d) in the compute
        dtype."""
        cfg = self.cfg
        T = frames.shape[1]
        x = frames.to(self.dtype) + sinusoidal_positions(
            T, cfg.d_model, frames.device).to(self.dtype)[None]
        positions = torch.arange(T, device=frames.device)
        for lp in params["enc_layers"]:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(self._enc_block, lp, x, positions, use_reentrant=False)
            else:
                x = self._enc_block(lp, x, positions)
        return rmsnorm(params["enc_norm"], x)

    def _dec_block(self, lp, x, positions, memory, mem_pos, kb=None, vb=None, pb=None):
        """Self-attention within x (train/prefill, returning its k/v) or over
        the (kb, vb) buffers after inserting x's (decode, returning the new
        buffers), then cross-attention into ``memory`` and the MLP."""
        cfg = self.cfg
        q, k, v = project_qkv(lp["self"], rmsnorm(lp["ln1"], x), positions,
                              geom=cfg.attn_geom, rope_theta=cfg.attn.rope_theta,
                              rope_sin_cos=self.rope_sin_cos)
        if kb is None:
            o = flash_attention(q, k, v, positions, positions, causal=True,
                                exp_fn=self.attn_exp)
            new = (k, v)
        else:
            kb, vb, _ = cache_insert(kb, vb, pb, k, v, positions)
            o = flash_attention(q, kb, vb, positions, pb, causal=True,
                                exp_fn=self.attn_exp)
            new = (kb, vb)
        x = x + shard(attention_out(lp["self"], o, cfg.attn_geom), "batch", None, None)
        # cross-attention into the encoder memory: no rope, all of it visible
        qx, _, _ = project_qkv(lp["cross"], rmsnorm(lp["lnx"], x), None,
                               geom=cfg.attn_geom, rope_theta=0.0)
        km, vm = project_kv(lp["cross"], memory, geom=cfg.attn_geom)
        ox = flash_attention(qx, km, vm, positions, mem_pos, causal=False,
                             exp_fn=self.attn_exp)
        x = x + shard(attention_out(lp["cross"], ox, cfg.attn_geom), "batch", None, None)
        x = x + shard(mlp(lp["mlp"], rmsnorm(lp["ln2"], x), self.act),
                      "batch", None, None)
        return x, new

    # ------------------------------- train -----------------------------------------

    def _train_dec_block(self, lp, x, positions, memory, mem_pos):
        return self._dec_block(lp, x, positions, memory, mem_pos)[0]

    def train_logits(self, params, batch):
        """batch["tokens"] (B, S) and batch["frames"] (B, enc_len, d).
        Returns the (B, S, V) f32 logits and a zero aux loss."""
        memory = self.encode(params, batch["frames"])
        mem_pos = torch.arange(memory.shape[1], device=memory.device)
        tokens = batch["tokens"]
        x = shard(embed(params["embed"], tokens, self.dtype), "batch", None, None)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for lp in params["dec_layers"]:
            if self.cfg.remat:
                x = checkpoint(self._train_dec_block, lp, x, positions, memory, mem_pos,
                               use_reentrant=False)
            else:
                x = self._train_dec_block(lp, x, positions, memory, mem_pos)
        return self._logits(params, x), torch.zeros((), dtype=torch.float32,
                                                    device=x.device)

    # ------------------------------- cache ------------------------------------------

    def init_cache(self, batch: int, cache_len: int, device: DeviceLike = None) -> Cache:
        """The class docstring's cache, empty (-1) positions and zero
        memory; ``device`` defaults to the model's (``"meta"`` gives shapes
        only)."""
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        kv = (cfg.n_layers, batch, cache_len, cfg.attn_geom.g_eff, cfg.head_dim)
        return {"k": torch.zeros(kv, dtype=torch.bfloat16, device=dev),
                "v": torch.zeros(kv, dtype=torch.bfloat16, device=dev),
                "pos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=dev),
                "memory": torch.zeros((batch, cfg.enc_len, cfg.d_model),
                                      dtype=torch.bfloat16, device=dev)}

    # --------------------------- prefill / decode ------------------------------------

    def prefill(self, params, batch, cache):
        """batch["tokens"] (B, S) and batch["frames"].  Returns the last
        position's logits (B, V) and a new cache."""
        memory = self.encode(params, batch["frames"])
        mem_pos = torch.arange(memory.shape[1], device=memory.device)
        tokens = batch["tokens"]
        x = shard(embed(params["embed"], tokens, self.dtype), "batch", None, None)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        W = cache["pos"].shape[1]
        ks, vs = [], []
        for i, lp in enumerate(params["dec_layers"]):
            x, (k, v) = self._dec_block(lp, x, positions, memory, mem_pos)
            kn, vn, pn = DecoderLM._ring_window(k, v, positions, W)
            kb, vb, pb = cache_insert(cache["k"][i], cache["v"][i], cache["pos"],
                                      kn, vn, pn)
            ks.append(kb)
            vs.append(vb)
        new = {"k": torch.stack(ks), "v": torch.stack(vs), "pos": pb,
               "memory": memory.to(torch.bfloat16)}
        return self._logits(params, x[:, -1:])[:, 0], new

    def decode_step(self, params, tok, pos, cache):
        """tok: (B, 1); pos: () shared absolute position, or (B,) per-slot
        positions."""
        x = shard(embed(params["embed"], tok, self.dtype), "batch", None, None)
        memory = cache["memory"].to(self.dtype)
        mem_pos = torch.arange(memory.shape[1], device=memory.device)
        positions, pb = _decode_positions(pos, cache["pos"], cache["pos"].shape[1])
        ks, vs = [], []
        for i, lp in enumerate(params["dec_layers"]):
            x, (kb, vb) = self._dec_block(lp, x, positions, memory, mem_pos,
                                          cache["k"][i], cache["v"][i], pb)
            ks.append(kb)
            vs.append(vb)
        new = {"k": torch.stack(ks), "v": torch.stack(vs), "pos": pb,
               "memory": cache["memory"]}
        return self._logits(params, x)[:, 0], new


# ======================================================================================
# VLM — vision prefix (stub) + decoder backbone
# ======================================================================================


class VLM(BaseLM):
    """A ``DecoderLM`` backbone over ``n_vis_tokens`` projected
    patch embeddings ``batch["patches"]`` (B, n_vis, d_vis) put before the
    token embeddings.  Parameters: the backbone's and ``vis_proj``
    (d_vis, d).  ``train_logits`` returns the text positions' logits; the
    cache is the backbone's at ``cache_len + n_vis_tokens``, and
    ``decode_step`` is the backbone's.  The engine's decode positions count
    tokens only (the reference's ``S + i``), so the first decode token
    lands in the ring slot of prefix position S and attends to positions
    <= S: the reference's behaviour, kept."""

    extra_inputs = ("patches",)

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None):
        super().__init__(cfg, device)
        self.backbone = DecoderLM(cfg, device)

    def init(self, gen: torch.Generator) -> Params:
        """The backbone's random f32 parameters, then ``vis_proj``."""
        params = self.backbone.init(gen)
        params["vis_proj"] = init_linear(gen, self.cfg.d_vis, self.cfg.d_model)
        return params

    def _prefix(self, params, batch):
        """Projected patch embeddings, then the token embeddings."""
        vis = linear(params["vis_proj"], batch["patches"].to(self.dtype))
        tok = shard(embed(params["embed"], batch["tokens"], self.dtype), "batch", None, None)
        return torch.cat([vis, tok], dim=1)

    def train_logits(self, params, batch):
        x, aux = self.backbone._train_stack(params, self._prefix(params, batch))
        x = x[:, batch["patches"].shape[1]:]  # the text positions only
        return self._logits(params, x), aux / self.cfg.n_layers

    def init_cache(self, batch: int, cache_len: int, device: DeviceLike = None) -> Cache:
        return self.backbone.init_cache(batch, cache_len + self.cfg.n_vis_tokens, device)

    def prefill(self, params, batch, cache):
        x, cache = self.backbone._prefill_stack(params, self._prefix(params, batch), cache)
        return self._logits(params, x[:, -1:])[:, 0], cache

    def decode_step(self, params, tok, pos, cache):
        return self.backbone.decode_step(params, tok, pos, cache)
