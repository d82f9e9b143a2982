"""internvl2-1b [vlm]: InternViT (STUB patch embeddings, d_vis=1024, 256 tokens) +
InternLM2 backbone: 24L d=896 14H (GQA kv=2) d_ff=4864 vocab=151655
[arXiv:2404.16821] — the JAX package's config, as data."""

from repro_torch.approx import ApproxConfig
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    act="silu",
    n_vis_tokens=256,
    d_vis=1024,
    approx=ApproxConfig(mode="table_ref", e_a=1e-4, algorithm="hierarchical",
                        omega=0.2),
)
