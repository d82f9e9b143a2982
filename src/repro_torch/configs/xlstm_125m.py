"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM blocks
[arXiv:2405.04517].  d_ff=0: xLSTM blocks carry their own internal projections.
The exp-gating (mLSTM/sLSTM input gates) is the table backend's hot spot
here — the JAX package's config, as data."""

from repro_torch.approx import ApproxConfig
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="xlstm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    act="gelu",
    approx=ApproxConfig(mode="table_ref", e_a=1e-4, algorithm="hierarchical",
                        omega=0.2),
)
