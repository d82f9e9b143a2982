"""Carry a JAX parameter tree over into the port's parameters.

``params_from_jax(cfg, tree)`` takes the tree of a ``repro`` model's ``init``,
handed over as numpy arrays (this module imports no JAX), and returns the
port's nested dict of tensors: the stacked layer axes are unstacked into lists
of per-layer dicts (``layers`` (L, ...) into a list; a local:global stack's
``layers_loc`` (n_groups, period-1, ...) into a list of n_groups lists and
``layers_glob`` (n_groups, ...) into a list; an MoE layer's ``moe`` subtree
unstacks alike: ``router.w`` (L, d, E), ``experts.wi``/``wu`` (L, E, d, f) and
``wd`` (L, E, f, d), and the ``shared`` GLU; a hybrid stack's ``mamba``
(n_groups, per_group, ...) into n_groups lists and ``mamba_tail`` (trailing,
...) into a list, its one ``shared`` attention+GLU block as it is; an xLSTM
stack's ``mlstm`` and ``slstm`` (n_pairs, ...) into lists; an encoder-decoder's
``enc_layers`` and ``dec_layers`` into lists, its ``enc_norm`` as it is; a
VLM's ``vis_proj`` as it is), and every weight keeps the JAX layout — ``wq``
stays (d, H, D) — except an attention block's ``wo`` (a layer's ``attn``, a
decoder layer's ``self`` and ``cross``), which is reshaped to (g_eff,
q_per_group, D, d) as ``attention_out`` contracts it.  The port and the reference then compute the same function,
which is what the parity tests compare.

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


# leading layer axes of each stacked subtree
_STACKS = {"layers": 1, "layers_loc": 2, "layers_glob": 1, "mamba": 2,
           "mamba_tail": 1, "mlstm": 1, "slstm": 1, "enc_layers": 1, "dec_layers": 1}
# a layer's attention blocks (an encoder-decoder's decoder layer has two)
_ATTN = ("attn", "self", "cross")


def params_from_jax(cfg: ArchConfig, tree: Mapping, device: DeviceLike = None) -> dict:
    """A JAX model's parameters (numpy leaves) -> the port's parameters."""
    dev = resolve_device(device)
    out = _tensors({k: v for k, v in tree.items() if k not in _STACKS}, dev)
    stacked = {k: _tensors(tree[k], dev) for k in _STACKS if k in tree}
    geom = cfg.attn_geom

    def attn_out_layout(lp):
        for name in _ATTN:
            if name in lp:
                wo = lp[name]["wo"]["w"]
                lp[name]["wo"]["w"] = wo.reshape(geom.g_eff, geom.q_per_group,
                                                 geom.d_head, -1)
        return lp

    def layer(sub, idx):
        if isinstance(sub, Mapping):
            return {k: layer(v, idx) for k, v in sub.items()}
        return sub[idx]

    def unstacked(name, n_axes, idx=()):
        """The stack ``name`` as nested lists over its ``n_axes`` leading
        axes, whose sizes its leaves carry."""
        if len(idx) < n_axes:
            leaf = stacked[name]
            while isinstance(leaf, Mapping):
                leaf = next(iter(leaf.values()))
            return [unstacked(name, n_axes, idx + (i,))
                    for i in range(leaf.shape[len(idx)])]
        return attn_out_layout(layer(stacked[name], idx))

    for name in stacked:
        out[name] = unstacked(name, _STACKS[name])
    if "shared" in out and "attn" in out["shared"]:  # the hybrid's one block
        attn_out_layout(out["shared"])
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
