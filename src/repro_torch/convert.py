"""Carry a JAX parameter tree over into the port's parameters.

``params_from_jax(cfg, tree)`` takes the tree of ``repro`` ``DecoderLM.init``,
handed over as numpy arrays (this module imports no JAX), and returns the
port's nested dict of tensors: the stacked layer axis is unstacked into a list
of per-layer dicts, and every weight keeps the JAX layout — ``wq`` stays
(d, H, D) — except ``wo``, which is reshaped to (g_eff, q_per_group, D, d) as
``attention_out`` contracts it.  The port and the reference then compute the
same function, which is what the parity tests compare.

``train_state_from_jax(cfg, state)`` converts a reference train state
(``{"params", "opt": {"m", "v", "count"}, "step"}``) the same way: the AdamW
moments share the parameters' layout.  The same mapping carries a tree of
gradients over (``params_from_jax`` on the grad tree).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ArchConfig


def _tensors(tree: Any, device: torch.device):
    if isinstance(tree, Mapping):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def params_from_jax(cfg: ArchConfig, tree: Mapping, device: DeviceLike = None) -> dict:
    """JAX ``DecoderLM`` parameters (numpy leaves) -> the port's parameters."""
    if "layers" not in tree:
        raise NotImplementedError(
            "only period-1 DecoderLM trees (a stacked 'layers' entry) convert "
            "so far; local:global stacks come with ROADMAP queue 1, item 11")
    dev = resolve_device(device)
    out = _tensors({k: v for k, v in tree.items() if k != "layers"}, dev)
    stacked = _tensors(tree["layers"], dev)
    geom = cfg.attn_geom

    def layer(i: int, sub):
        if isinstance(sub, Mapping):
            return {k: layer(i, v) for k, v in sub.items()}
        return sub[i]

    out["layers"] = []
    for i in range(cfg.n_layers):
        lp = layer(i, stacked)
        wo = lp["attn"]["wo"]["w"]
        lp["attn"]["wo"]["w"] = wo.reshape(geom.g_eff, geom.q_per_group,
                                           geom.d_head, -1)
        out["layers"].append(lp)
    return out


def train_state_from_jax(cfg: ArchConfig, state: Mapping,
                         device: DeviceLike = None) -> dict:
    """JAX train state (numpy leaves) -> the port's train state."""
    dev = resolve_device(device)
    opt = state["opt"]
    scalar = lambda a: torch.tensor(np.array(a), dtype=torch.int32, device=dev)
    return {"params": params_from_jax(cfg, state["params"], dev),
            "opt": {"m": params_from_jax(cfg, opt["m"], dev),
                    "v": params_from_jax(cfg, opt["v"], dev),
                    "count": scalar(opt["count"])},
            "step": scalar(state["step"])}
