"""whisper-small [audio]: enc-dec, 12L decoder d=768 12H d_ff=3072 vocab=51865,
conv frontend STUBBED to precomputed frame embeddings (B, 1500, d)
[arXiv:2212.04356] — the JAX package's config, as data."""

from repro_torch.approx import ApproxConfig
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    act="gelu",
    mlp_kind="mlp",
    n_enc_layers=12,
    enc_len=1500,
    approx=ApproxConfig(mode="table_ref", e_a=1e-4, algorithm="hierarchical",
                        omega=0.2),
)
