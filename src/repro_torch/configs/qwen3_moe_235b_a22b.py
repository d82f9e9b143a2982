"""qwen3-moe-235b-a22b [moe]: 94L d=4096 64H (GQA kv=4, head_dim=128) expert_ff=1536
vocab=151936, 128 experts top-8, qk-norm [hf:Qwen/Qwen3 family] — the JAX
package's config, as data."""

from repro_torch.approx import ApproxConfig
from repro_torch.models.config import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=1536,
    vocab=151936,
    act="silu",
    moe=MoEConfig(n_experts=128, top_k=8, n_shared=0),
    attn=AttnConfig(qk_norm=True, rope_theta=1_000_000.0),
    approx=ApproxConfig(mode="table_ref", e_a=1e-4, algorithm="hierarchical",
                        omega=0.2),
)
