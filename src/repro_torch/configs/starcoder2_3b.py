"""starcoder2-3b [dense]: 30L d=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 — GQA,
RoPE, plain 2-matrix GELU MLP [arXiv:2402.19173] — the JAX package's config,
as data."""

from repro_torch.approx import ApproxConfig
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    act="gelu",
    mlp_kind="mlp",
    approx=ApproxConfig(mode="table_ref", e_a=1e-4, algorithm="hierarchical",
                        omega=0.2),
)
