"""Architecture configuration, mirrored as data from the JAX package's
``models/config.py``: ``ArchConfig``, ``ShapeSpec`` and the dry run's shape
registry (``ALL_SHAPES``, ``shapes_for``).

``ArchConfig`` is the single source of truth consumed by the model constructors
and the launcher.  One instance per ported architecture lives in
``repro_torch/configs/<id>.py``; tests/test_torch_model.py holds its fields
equal to the reference config's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

from repro_torch.approx.activations import ApproxConfig

# Families
DENSE = "dense"
MOE = "moe"
SSM_HYBRID = "hybrid"  # mamba2 blocks + shared attention (zamba2)
XLSTM = "xlstm"
ENCDEC = "encdec"  # whisper
VLM = "vlm"  # vision stub + decoder LM


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0  # routed experts
    top_k: int = 0
    n_shared: int = 0  # always-on shared experts
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # device-limited routing (DeepSeek-V3): tokens route into at most
    # ``max_groups`` of ``device_groups`` EP shards (0 = unrestricted)
    device_groups: int = 0
    max_groups: int = 0


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64  # N
    head_dim: int = 64  # P (per-head channels)
    conv_width: int = 4
    expand: int = 2  # inner dim = expand * d_model
    chunk: int = 256  # chunkwise-scan length


# Width of the 'model' mesh axis in the production mesh.  Attention geometry is
# normalized so KV groups shard exactly TARGET_GROUPS ways: KV heads are
# activation-replicated (never parameter-replicated — GQA ties stay faithful) and
# Q heads are zero-padded + masked (function-preserving; the pad waste is visible
# in the roofline useful-FLOPs ratio).  The port runs on one card but keeps the
# same normalized geometry, so the JAX parameter tree converts one to one.
TARGET_GROUPS = 16


@dataclass(frozen=True)
class AttnGeom:
    """Normalized attention geometry: logical (h, g) -> effective (h_eff, g_eff)."""

    h_log: int  # architecture's q heads
    g_log: int  # architecture's kv heads
    h_eff: int  # padded q heads (multiple of g_eff * ... )
    g_eff: int  # effective kv groups (shards exactly over 'model')
    repeat: int  # kv activation-replication factor
    g_zero_pad: int  # zero kv groups appended (only when TARGET_GROUPS % g != 0)
    d_head: int

    @property
    def q_per_group(self) -> int:
        return self.h_eff // self.g_eff

    @property
    def is_padded(self) -> bool:
        return self.h_eff != self.h_log or self.g_zero_pad > 0


def make_attn_geom(n_heads: int, n_kv: int, d_head: int,
                   target: int = TARGET_GROUPS) -> AttnGeom:
    if n_kv % target == 0:
        g_eff, repeat, zero = n_kv, 1, 0
        h_eff = n_kv * -(-n_heads // n_kv)  # pad to a multiple of the group count
    elif target % n_kv == 0:
        g_eff, repeat, zero = target, target // n_kv, 0
        # per-logical-group q count must divide evenly across the kv replicas
        unit = n_kv * repeat
        h_eff = unit * -(-n_heads // unit)
    else:  # e.g. whisper's 12 MHA heads: zero-pad kv groups up to target
        g_eff, repeat, zero = target, 1, target - n_kv
        h_eff = g_eff * -(-n_heads // g_eff)
    return AttnGeom(h_log=n_heads, g_log=n_kv, h_eff=h_eff, g_eff=g_eff,
                    repeat=repeat, g_zero_pad=zero, d_head=d_head)


@dataclass(frozen=True)
class AttnConfig:
    # sliding-window pattern: every `global_every`-th layer is global, others use
    # `window`; window=0 => all layers global (standard causal attention).
    window: int = 0
    global_every: int = 1
    logit_softcap: float = 0.0  # final-logit softcap (gemma), 0 = off
    qk_norm: bool = False
    rope_theta: float = 10_000.0


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 => d_model // n_heads
    act: str = "silu"  # MLP activation routed through the approx backend
    mlp_kind: str = "glu"  # "glu" (llama-style) | "mlp" (2-matrix, starcoder/whisper)
    tie_embeddings: bool = False
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    attn: AttnConfig = field(default_factory=AttnConfig)
    approx: ApproxConfig = field(default_factory=ApproxConfig)
    # enc-dec (whisper): encoder stack depth and source length; frontends are stubs
    n_enc_layers: int = 0
    enc_len: int = 0
    # vlm: number of vision-prefix patch embeddings (precomputed, stub frontend)
    n_vis_tokens: int = 0
    d_vis: int = 0
    # hybrid: one shared attention block applied every k ssm layers
    shared_attn_every: int = 0
    # numerics / memory
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def attn_geom(self) -> AttnGeom:
        return make_attn_geom(self.n_heads, self.n_kv_heads, self.head_dim)

    @property
    def vocab_pad(self) -> int:
        """Embedding rows padded to a multiple of 16*128 so the vocab dim shards
        evenly over 'model' with lane-aligned per-shard tiles (Megatron-style).
        Pad logits are masked to -inf in the head; pad rows never train."""
        return -(-self.vocab // 2048) * 2048

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for MODEL_FLOPS = 6*N*D and memory budgeting) -----

    def param_count(self) -> int:
        d, v = self.d_model, self.vocab
        hd = self.head_dim
        n_emb = v * d * (1 if self.tie_embeddings else 2)

        def attn_params():
            return d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (
                self.n_heads * hd
            ) * d

        def glu_params(ff):
            return 3 * d * ff

        if self.family in (DENSE, VLM):
            per_layer = attn_params() + glu_params(self.d_ff) + 2 * d
            n = self.n_layers * per_layer + n_emb
            if self.family == VLM:
                n += self.d_vis * d  # vision projector
            return n
        if self.family == MOE:
            ex = (self.moe.n_experts + self.moe.n_shared) * glu_params(self.d_ff)
            router = d * self.moe.n_experts
            per_layer = attn_params() + ex + router + 2 * d
            return self.n_layers * per_layer + n_emb
        if self.family == SSM_HYBRID:
            inner = self.ssm.expand * d
            n_h = inner // self.ssm.head_dim
            per_ssm = (
                d * (2 * inner + 2 * self.ssm.state_dim + n_h)  # in_proj(zx,B,C,dt)
                + inner * self.ssm.conv_width
                + inner * d  # out proj
                + n_h  # A_log
                + 2 * d
            )
            shared = attn_params() + glu_params(self.d_ff) + 2 * d
            return self.n_layers * per_ssm + shared + n_emb
        if self.family == XLSTM:
            per_m = 4 * d * d + d * 3 * self.n_heads + 2 * d + 2 * d * self.d_ff_x()
            per_s = 4 * d * 2 + 4 * d * d // 1 + 2 * d  # gates z,i,f,o as d->d
            n_m = (self.n_layers + 1) // 2
            n_s = self.n_layers // 2
            return n_m * per_m + n_s * per_s + n_emb
        if self.family == ENCDEC:
            enc_per = attn_params() + 2 * d * self.d_ff + 2 * d
            dec_per = 2 * attn_params() + 2 * d * self.d_ff + 3 * d
            return (
                self.n_enc_layers * enc_per + self.n_layers * dec_per + n_emb
            )
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active params per token (= total for non-MoE)."""
        if self.family != MOE:
            return self.param_count()
        d = self.d_model
        ex_all = (self.moe.n_experts + self.moe.n_shared) * 3 * d * self.d_ff
        ex_act = (self.moe.top_k + self.moe.n_shared) * 3 * d * self.d_ff
        return self.param_count() - self.n_layers * (ex_all - ex_act)

    def d_ff_x(self) -> int:
        # xLSTM mLSTM up-projection factor 2 when d_ff is unset in the assignment
        return self.d_ff if self.d_ff > 0 else 2 * self.d_model


@dataclass(frozen=True)
class ShapeSpec:
    """One input shape: the trainer's global batch and sequence length."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}

# long_500k runs only for the sub-quadratic architectures: the linear-state
# ones and gemma3 (5:1 local:global, so 8 of its 48 layers hold a 500k KV)
LONG_CONTEXT_ARCHS = {"xlstm-125m", "zamba2-1.2b", "gemma3-12b"}


def shapes_for(arch: ArchConfig) -> Tuple[ShapeSpec, ...]:
    """The dry run's shape cells of ``arch``."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch.name in LONG_CONTEXT_ARCHS:
        out.append(LONG_500K)
    return tuple(out)
