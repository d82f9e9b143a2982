"""gemma3-12b [dense]: 48L d=3840 16H (GQA kv=8, head_dim=256) d_ff=15360
vocab=262144 — 5:1 local:global sliding-window pattern, qk-norm, 128k-class
context [hf:google/gemma-3 family] — the JAX package's config, as data.  Local
layers keep a ``LOCAL_WINDOW``-token ring KV cache
(``repro_torch.models.transformer``)."""

from repro_torch.approx import ApproxConfig
from repro_torch.models.config import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=15360,
    vocab=262144,
    act="gelu_tanh",
    tie_embeddings=True,
    attn=AttnConfig(global_every=6, qk_norm=True, rope_theta=1_000_000.0),
    approx=ApproxConfig(mode="table_ref", e_a=1e-4, algorithm="hierarchical",
                        omega=0.2),
)
