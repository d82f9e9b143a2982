"""zamba2-1.2b [hybrid]: 38 Mamba2 layers d=2048, ssm_state=64, + ONE shared
(weight-tied) attention+MLP block (32H, d_ff=8192) applied every 6 layers
[arXiv:2411.15242].  vocab=32000 — the JAX package's config, as data."""

from repro_torch.approx import ApproxConfig
from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    act="silu",
    ssm=SSMConfig(state_dim=64, head_dim=64, conv_width=4, expand=2, chunk=256),
    shared_attn_every=6,
    approx=ApproxConfig(mode="table_ref", e_a=1e-4, algorithm="hierarchical",
                        omega=0.2),
)
