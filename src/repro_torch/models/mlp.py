"""Feed-forward blocks: gated-linear-unit MLP and the plain 2-matrix MLP.

All nonlinearities route through the paper's table backend via ``act``.  The
MoE block comes with the MoE family (ROADMAP queue 1, item 11c).
"""

from __future__ import annotations

from typing import Callable

import torch

from .common import Params, init_linear, linear


def init_glu(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32) -> Params:
    return {
        "wi": init_linear(gen, d_model, d_ff, dtype=dtype),  # gate branch
        "wu": init_linear(gen, d_model, d_ff, dtype=dtype),  # linear branch
        "wd": init_linear(gen, d_ff, d_model, dtype=dtype),
    }


def glu(p: Params, x: torch.Tensor, act: Callable) -> torch.Tensor:
    return linear(p["wd"], act(linear(p["wi"], x)) * linear(p["wu"], x))


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32) -> Params:
    """Plain 2-matrix MLP (whisper/starcoder style)."""
    return {
        "wi": init_linear(gen, d_model, d_ff, dtype=dtype),
        "wd": init_linear(gen, d_ff, d_model, dtype=dtype),
    }


def mlp(p: Params, x: torch.Tensor, act: Callable) -> torch.Tensor:
    return linear(p["wd"], act(linear(p["wi"], x)))
