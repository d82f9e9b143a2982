"""Model factory for the ported architectures."""

from __future__ import annotations

import importlib

from repro_torch.device import DeviceLike

from .config import DENSE, ArchConfig
from .transformer import DecoderLM

# The JAX package registers ten architectures; the port serves its dense
# family (the MoE, hybrid, xLSTM, encoder-decoder and vision families come
# with ROADMAP queue 1, items 11c-f).
ARCH_IDS = ("stablelm-3b", "yi-34b", "gemma3-12b", "starcoder2-3b")


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not ported yet (ported: {ARCH_IDS}); "
            "ROADMAP queue 1, items 11c-f")
    mod_name = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def reduced(arch_id: str) -> ArchConfig:
    """Family-preserving shrink for tests and ``--reduced`` runs: few layers,
    small width, tiny vocab — the dense branch of the JAX package's
    ``tests/test_archs.py::reduced``."""
    cfg = get_config(arch_id)
    if cfg.family != DENSE:
        raise NotImplementedError(f"reduced(): family {cfg.family!r} not ported")
    period = max(1, cfg.attn.global_every)
    return cfg.replace(d_model=64, vocab=128, remat=False, n_layers=2 * period,
                       n_heads=4, n_kv_heads=2, d_head=16, d_ff=128)


def build_model(cfg: ArchConfig, device: DeviceLike = None) -> DecoderLM:
    """Construct the model for ``cfg`` on ``device`` (default ``cuda``)."""
    return DecoderLM(cfg, device)
