"""Partition specs for serving caches (KV buffers, SSM / xLSTM states) — the
JAX package's ``parallel/cache_specs.py``.

Name-based rules over the cache tree, divisibility-aware like params.py;
trailing-dim templates, extra leading dims (layer stacks / groups) replicate.
The port's caches stack their layers as the reference's do; the recurrent
families keep flat keys (``mamba_state``, ``m_c``), which read as the
reference's nested paths (``mamba/state``, ``m/c``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np

from .sharding import P, axis_sizes, default_rules

_RULES = (
    # attention KV buffers: (..., B, W, G, D)
    (r"(^|/)(k|v|loc_k|loc_v|glob_k|glob_v|attn_k|attn_v)$",
     ("batch", None, "heads", None)),
    (r"(^|/)memory$", ("batch", None, None)),
    # per-slot position/validity buffers: (B, W) int32, batch-sharded with k/v
    (r"pos$", ("batch", None)),
    # mamba2 state: (..., B, H, P, N); conv carries: (..., B, K-1, C)
    (r"(^|/)state$", ("batch", "ff", None, None)),
    (r"(^|/)conv_x$", ("batch", None, "ff")),
    (r"(^|/)conv_[bc]$", ("batch", None, None)),
    # mLSTM: c (..., B, H, D, D); n (..., B, H, D); m (..., B, H)
    (r"(^|/)m/c$", ("batch", None, None, "model")),
    (r"(^|/)m/n$", ("batch", None, "model")),
    (r"(^|/)m/m$", ("batch", None)),
    # sLSTM: (..., B, d)
    (r"(^|/)s/[hcnm]$", ("batch", "model")),
)

# the port's flat cache keys -> the reference's nested paths
_NESTED = (("mamba_tail_", "mamba_tail/"), ("mamba_", "mamba/"), ("m_", "m/"),
           ("s_", "s/"))


def path_str(key: str) -> str:
    """A port cache key as the reference's path."""
    for flat, nested in _NESTED:
        if key.startswith(flat):
            return nested + key[len(flat):]
    return key


def cache_pspecs(cache, mesh, rules: Optional[Dict[str, Any]] = None):
    """Spec of every tensor of the cache dict ``cache`` (same keys)."""
    rules = rules or default_rules(mesh)
    sizes = axis_sizes(mesh)

    def assign(key, leaf):
        ps = path_str(key)
        for pat, template in _RULES:
            if re.search(pat, ps):
                n_extra = leaf.dim() - len(template)
                if n_extra < 0:
                    continue
                spec = [None] * n_extra
                for dim, logical in zip(leaf.shape[n_extra:], template):
                    ax = rules.get(logical) if logical else None
                    if ax is not None:
                        size = int(np.prod([sizes[a] for a in
                                            (ax if isinstance(ax, tuple) else (ax,))]))
                        if dim % size != 0:
                            ax = None
                    spec.append(ax)
                return P(*spec)
        return P()

    return {k: assign(k, v) for k, v in cache.items()}
