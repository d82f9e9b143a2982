"""Model factory for the ported architectures."""

from __future__ import annotations

import importlib

from repro_torch.device import DeviceLike
from repro_torch.parallel.sharding import current_mesh, mesh_device, use_sharding

from .config import (DENSE, ENCDEC, MOE, SSM_HYBRID, VLM as VLM_FAM, XLSTM, ArchConfig,
                     MoEConfig, SSMConfig)
from .transformer import VLM, BaseLM, DecoderLM, EncDecLM, HybridLM, XLSTMLM

# the JAX package's ten architectures, in its order
ARCH_IDS = ("xlstm-125m", "deepseek-moe-16b", "qwen3-moe-235b-a22b", "stablelm-3b",
            "yi-34b", "gemma3-12b", "starcoder2-3b", "whisper-small", "zamba2-1.2b",
            "internvl2-1b")


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise NotImplementedError(f"unknown architecture {arch_id!r} (the JAX "
                                  f"package's and the port's: {ARCH_IDS})")
    mod_name = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def reduced(arch_id: str) -> ArchConfig:
    """Family-preserving shrink for tests and ``--reduced`` runs: few layers,
    small width, few experts, tiny vocab — the JAX package's
    ``tests/test_archs.py::reduced``."""
    cfg = get_config(arch_id)
    kw = dict(d_model=64, vocab=128, remat=False)
    if cfg.family == XLSTM:
        kw.update(n_layers=2, n_heads=2, n_kv_heads=2, d_ff=0)
    elif cfg.family == MOE:
        kw.update(n_layers=2, n_heads=4,
                  n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
                  d_head=16, d_ff=32,
                  moe=MoEConfig(n_experts=4, top_k=2, n_shared=cfg.moe.n_shared))
    elif cfg.family == SSM_HYBRID:
        kw.update(n_layers=5, n_heads=4, n_kv_heads=4, d_ff=128,
                  ssm=SSMConfig(state_dim=8, head_dim=16, conv_width=4, expand=2,
                                chunk=8),
                  shared_attn_every=2)  # 2 groups of 2 + 1 trailing
    elif cfg.family == ENCDEC:
        kw.update(n_layers=2, n_enc_layers=2, n_heads=4, n_kv_heads=4, d_ff=128,
                  enc_len=12)
    elif cfg.family == VLM_FAM:
        kw.update(n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, n_vis_tokens=4,
                  d_vis=16)
    else:  # dense
        period = max(1, cfg.attn.global_every)
        kw.update(n_layers=2 * period, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128)
    return cfg.replace(**kw)


def build_model(cfg: ArchConfig, device: DeviceLike = None, mesh=None) -> BaseLM:
    """Construct the family's model for ``cfg`` on ``device`` (default
    ``cuda``; on a mesh, this rank's device of it).

    ``mesh`` (default: the active ``use_sharding`` mesh, if any) places a
    sharded-mode approx pack over the mesh and builds the activation closures
    under ``use_sharding(mesh)``, so each 'model' rank's closures hold its one
    values slice (``ApproxConfig.place_packs``)."""
    if mesh is None:
        mesh = current_mesh()
    if mesh is None:
        return _construct(cfg, device)
    if device is None:
        device = mesh_device(mesh)
    cfg.approx.place_packs(mesh)
    with use_sharding(mesh):
        return _construct(cfg, device)


def _construct(cfg: ArchConfig, device: DeviceLike) -> BaseLM:
    if cfg.family == SSM_HYBRID:
        return HybridLM(cfg, device)
    if cfg.family == XLSTM:
        return XLSTMLM(cfg, device)
    if cfg.family == ENCDEC:
        return EncDecLM(cfg, device)
    if cfg.family == VLM_FAM:
        return VLM(cfg, device)
    if cfg.family in (DENSE, MOE):
        return DecoderLM(cfg, device)
    raise ValueError(f"unknown family {cfg.family!r}")
