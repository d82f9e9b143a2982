"""deepseek-moe-16b [moe]: 28L d=2048 16H (MHA, kv=16) expert_ff=1408 vocab=102400,
64 routed top-6 + 2 shared, fine-grained [arXiv:2401.06066] — the JAX package's
config, as data."""

from repro_torch.approx import ApproxConfig
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    act="silu",
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2),
    approx=ApproxConfig(mode="table_ref", e_a=1e-4, algorithm="hierarchical",
                        omega=0.2),
)
