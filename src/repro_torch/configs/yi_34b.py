"""yi-34b [dense]: 60L d=7168 56H (GQA kv=8, head_dim=128) d_ff=20480 vocab=64000 —
llama-arch GQA [arXiv:2403.04652] — the JAX package's config, as data."""

from repro_torch.approx import ApproxConfig
from repro_torch.models.config import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20480,
    vocab=64000,
    act="silu",
    attn=AttnConfig(rope_theta=5_000_000.0),
    approx=ApproxConfig(mode="table_ref", e_a=1e-4, algorithm="hierarchical",
                        omega=0.2),
)
