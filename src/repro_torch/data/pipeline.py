"""Deterministic, counter-addressed synthetic data pipeline — the port's own
copy of the JAX package's ``data/pipeline.py`` (plain numpy, the same batches
for the same ``(seed, step)``).

Every batch is a pure function of (seed, step) via Philox counter streams, so
restart-after-failure resumes the exact token stream with no replay state:
the checkpoint stores only ``step``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    # modality stubs
    enc_len: int = 0
    d_frames: int = 0
    n_vis_tokens: int = 0
    d_vis: int = 0


class SyntheticLM:
    """Markov-ish synthetic token stream (learnable structure, not uniform noise):
    tokens follow t_{i+1} = (a * t_i + b_i) mod V with per-sequence a and Philox
    noise b — next-token prediction has non-trivial but learnable statistics."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=self.cfg.seed, counter=np.uint64(step)))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = self._rng(step)
        B, S, V = c.global_batch, c.seq_len, c.vocab
        a = rng.integers(1, 8, size=(B, 1), dtype=np.int64)
        noise = rng.integers(0, 3, size=(B, S), dtype=np.int64)
        t0 = rng.integers(0, V, size=(B, 1), dtype=np.int64)
        toks = np.empty((B, S + 1), dtype=np.int64)
        toks[:, :1] = t0
        for i in range(S):
            toks[:, i + 1] = (a[:, 0] * toks[:, i] + noise[:, i]) % V
        batch = {
            "tokens": toks[:, :S].astype(np.int32),
            "targets": toks[:, 1 : S + 1].astype(np.int32),
        }
        if c.enc_len:
            batch["frames"] = rng.normal(
                0, 1, size=(B, c.enc_len, c.d_frames)).astype(np.float32)
        if c.n_vis_tokens:
            batch["patches"] = rng.normal(
                0, 1, size=(B, c.n_vis_tokens, c.d_vis)).astype(np.float32)
        return batch

    def host_shard(self, batch: Dict[str, np.ndarray], host_id: int,
                   n_hosts: int) -> Dict[str, np.ndarray]:
        """Host ``host_id``'s contiguous rows of a global batch (of
        ``n_hosts``; the batch divides evenly)."""
        B = batch["tokens"].shape[0]
        per = B // n_hosts
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in batch.items()}


def data_config_for(arch_cfg, shape) -> DataConfig:
    return DataConfig(
        vocab=arch_cfg.vocab,
        global_batch=shape.global_batch,
        seq_len=shape.seq_len,
        enc_len=arch_cfg.enc_len,
        d_frames=arch_cfg.d_model if arch_cfg.family == "encdec" else 0,
        n_vis_tokens=arch_cfg.n_vis_tokens,
        d_vis=arch_cfg.d_vis,
    )
