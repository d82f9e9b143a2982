"""Model factory for the ported architectures."""

from __future__ import annotations

import importlib

from repro_torch.device import DeviceLike

from .config import DENSE, MOE, ArchConfig, MoEConfig
from .transformer import DecoderLM

# The JAX package registers ten architectures; the port serves its dense and
# MoE families (the hybrid, xLSTM, encoder-decoder and vision families come
# with ROADMAP queue 1, items 11d-f).
ARCH_IDS = ("stablelm-3b", "yi-34b", "gemma3-12b", "starcoder2-3b",
            "deepseek-moe-16b", "qwen3-moe-235b-a22b")


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not ported yet (ported: {ARCH_IDS}); "
            "ROADMAP queue 1, items 11d-f")
    mod_name = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def reduced(arch_id: str) -> ArchConfig:
    """Family-preserving shrink for tests and ``--reduced`` runs: few layers,
    small width, few experts, tiny vocab — the dense and MoE branches of the
    JAX package's ``tests/test_archs.py::reduced``."""
    cfg = get_config(arch_id)
    kw = dict(d_model=64, vocab=128, remat=False)
    if cfg.family == MOE:
        kw.update(n_layers=2, n_heads=4,
                  n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
                  d_head=16, d_ff=32,
                  moe=MoEConfig(n_experts=4, top_k=2, n_shared=cfg.moe.n_shared))
    elif cfg.family == DENSE:
        period = max(1, cfg.attn.global_every)
        kw.update(n_layers=2 * period, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128)
    else:
        raise NotImplementedError(f"reduced(): family {cfg.family!r} not ported")
    return cfg.replace(**kw)


def build_model(cfg: ArchConfig, device: DeviceLike = None) -> DecoderLM:
    """Construct the model for ``cfg`` on ``device`` (default ``cuda``)."""
    return DecoderLM(cfg, device)
