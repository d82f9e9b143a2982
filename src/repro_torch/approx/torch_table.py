"""PyTorch runtime of a :class:`repro_torch.core.table.TableSpec` — the
counterpart of the JAX package's ``approx/jax_table.py``.

The evaluation mirrors the paper's Fig. 7 circuit:

  interval selector  — branchless comparator *plane*: one broadcast compare of x
                       against the boundary row plus one sum yields
                       j = #(x >= b_m, m >= 1); four gathers then fetch
                       (p_j, inv_d_j, base_j, seg_j).
  address generator  — i = clip(floor((x - p_j) * inv_d_j), 0, seg_j - 1).
  BRAM lookup        — one adjacent-pair gather from the packed values vector.
  interpolation      — y0 + t * (y1 - y0).

Every step is its own PyTorch op, so each product and sum rounds to f32 on its
own: the result is bit-identical to the JAX package's *eager* (unjitted)
``eval_table_ref``.  (Under ``jax.jit`` XLA contracts the lerp into an FMA,
which moves about 7% of points by 1 ULP.)  The CUDA kernels in
:mod:`repro_torch.kernels` are built with ``-fmad=false`` for the same
reason: they match this body bit for bit.

``make_table_fn`` is differentiable through :func:`slope_rule`, the
``torch.autograd.Function`` counterpart of the reference's ``custom_jvp``:
the backward pass multiplies the saved table slope (or ``exact_d1(x)``) into
the incoming gradient.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.table import TableSpec
from repro_torch.device import DeviceLike, resolve_device

# f32 represents every integer below 2^24 exactly: table addresses live in f32
EXACT_INT_LIMIT = 1 << 24


@dataclass(frozen=True)
class TorchTable:
    """Device-ready table artifact (all tensors f32 on one device)."""

    boundaries: torch.Tensor  # (n+1,) f32
    inv_delta: torch.Tensor  # (n,)   f32
    delta: torch.Tensor  # (n,)   f32
    base: torch.Tensor  # (n,)   f32 (exact integers < 2^24)
    seg_count: torch.Tensor  # (n,)   f32
    values: torch.Tensor  # (M_F,) f32
    # the table's staging image, built once with the table (the port's own,
    # for its kernels): the row (n + 1 boundaries, then the n inv_delta,
    # base and seg_count), then the M_F values, zero-padded to a 16-byte
    # multiple; member_image_layout([n]) of approx/table_pack.py.  What a
    # block of the table kernels stages where it fits
    image: torch.Tensor = field(init=False, compare=False, repr=False)

    def __post_init__(self):
        parts = [self.boundaries, self.inv_delta, self.base, self.seg_count, self.values]
        pad = -sum(t.numel() for t in parts) % 4
        parts.append(self.values.new_zeros(pad))
        object.__setattr__(self, "image", torch.cat(parts).contiguous())

    @property
    def n_intervals(self) -> int:
        return self.inv_delta.shape[0]

    @property
    def footprint(self) -> int:
        return self.values.shape[0]


def f32_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """f64/i64 design-flow array -> f32 tensor (numpy rounds to nearest, as
    ``jnp.asarray(a, jnp.float32)`` does)."""
    return torch.from_numpy(np.asarray(a, dtype=np.float64).astype(np.float32)).to(device)


def from_spec(spec: TableSpec, device: DeviceLike = None) -> TorchTable:
    if spec.footprint >= EXACT_INT_LIMIT:
        raise ValueError("table footprint exceeds f32 exact-integer range")
    dev = resolve_device(device)
    return TorchTable(
        boundaries=f32_tensor(spec.boundaries, dev),
        inv_delta=f32_tensor(spec.inv_delta, dev),
        delta=f32_tensor(spec.delta, dev),
        base=f32_tensor(spec.base, dev),
        seg_count=f32_tensor(spec.seg_count, dev),
        values=f32_tensor(spec.values, dev),
    )


def select_interval(boundaries: torch.Tensor, n_intervals: int,
                    xf: torch.Tensor) -> torch.Tensor:
    """Vectorized comparator plane: j(x) = min(#(x >= b_m, m >= 1), n-1).

    ``boundaries`` may be right-padded with +inf (a pack row): padding only
    compares true for x = +inf, and the min pins that into the last real
    sub-interval (the address clamp).
    """
    j = (xf.unsqueeze(-1) >= boundaries[1:]).sum(dim=-1)
    return torch.clamp(j, max=n_intervals - 1)


def _select_params(brow, invd_row, base_row, segs_row, n_intervals, xf):
    """Per-element (p_j, inv_d_j, base_j, seg_j): one selector, four gathers."""
    j = select_interval(brow, n_intervals, xf)
    return brow[j], invd_row[j], base_row[j], segs_row[j]


def clamp_cell(u: torch.Tensor, segs: torch.Tensor) -> torch.Tensor:
    """The cell index ``i = clip(floor(u), 0, segs - 1)`` (NaN stays NaN)."""
    return torch.minimum(torch.clamp(torch.floor(u), min=0.0), segs - 1.0)


def _address(af: torch.Tensor) -> torch.Tensor:
    """f32 address -> int64; a NaN address (from a NaN input) becomes 0, as
    XLA's float-to-int conversion makes it, so no NaN reaches the integer
    conversion."""
    return torch.where(af >= 0, af, 0.0).to(torch.int64)


def pair_address(base, i, n_values: int):
    """(a, a+1) gather addresses, clamped into [0, M-1] like ``mode="clip"``."""
    a = _address(base + i)
    return a.clamp(max=n_values - 1), (a + 1).clamp(max=n_values - 1)


def lane_address(af: torch.Tensor, n_values: int) -> torch.Tensor:
    """One gather address from its f32 form, clamped into [0, M-1]."""
    return _address(af).clamp(max=n_values - 1)


def lookup_rows(brow, invd_row, base_row, segs_row, n_intervals: int,
                values, x: torch.Tensor, *, extrapolate: bool) -> torch.Tensor:
    """The shared lookup body over one metadata row (table or pack member).

    The plain PyTorch version of the CUDA per-element body
    (``csrc/table_lookup.cuh``): same op order, one rounding per op.
    """
    dtype = x.dtype
    xf = x.to(torch.float32)
    p, invd, base, segs = _select_params(brow, invd_row, base_row, segs_row,
                                         n_intervals, xf)
    u = (xf - p) * invd
    i = clamp_cell(u, segs)
    a0, a1 = pair_address(base, i, values.shape[0])
    y0 = values[a0]
    y1 = values[a1]
    t = u - i
    if not extrapolate:
        t = torch.clamp(t, 0.0, 1.0)
    return (y0 + t * (y1 - y0)).to(dtype)


def eval_table_ref(jt: TorchTable, x: torch.Tensor, *,
                   extrapolate: bool = False) -> torch.Tensor:
    """Plain PyTorch table evaluation, bit-identical to eager ``eval_table_ref``.

    ``extrapolate=False`` saturates out-of-interval inputs at the edge breakpoint
    values (the hardware's address clamp); ``extrapolate=True`` extends the edge
    segments linearly (activations with linear asymptotes: gelu/silu/softplus).
    """
    return lookup_rows(jt.boundaries, jt.inv_delta, jt.base, jt.seg_count,
                       jt.n_intervals, jt.values, x, extrapolate=extrapolate)


def slope_rows(brow, invd_row, base_row, segs_row, n_intervals: int, values,
               x: torch.Tensor, *, extrapolate: bool) -> torch.Tensor:
    """d/dx of the piecewise-linear surrogate over one metadata row."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    p, invd, base, segs = _select_params(brow, invd_row, base_row, segs_row,
                                         n_intervals, xf)
    i = clamp_cell((xf - p) * invd, segs)
    a0, a1 = pair_address(base, i, values.shape[0])
    slope = (values[a1] - values[a0]) * invd
    if not extrapolate:
        inside = (xf >= brow[0]) & (xf < brow[n_intervals])
        slope = slope * inside.to(torch.float32)
    return slope.to(dtype)


def eval_table_slope(jt: TorchTable, x: torch.Tensor, *,
                     extrapolate: bool = False) -> torch.Tensor:
    """The segment slope (a.e. derivative), zeroed outside [b_0, b_n) unless
    extrapolating — bit-identical to eager ``eval_table_slope``."""
    return slope_rows(jt.boundaries, jt.inv_delta, jt.base, jt.seg_count,
                      jt.n_intervals, jt.values, x, extrapolate=extrapolate)


class _SlopeRule(torch.autograd.Function):
    """``y`` from ``fused(x) -> (y, slope)``; backward ``slope * dy`` (in x's
    dtype), as the JAX package's custom_jvp returns ``slope * dx``."""

    @staticmethod
    def forward(ctx, x, fused):
        y, slope = fused(x)
        ctx.save_for_backward(slope)
        return y

    @staticmethod
    def backward(ctx, dy):
        (slope,) = ctx.saved_tensors
        return slope * dy, None


def slope_rule(value, fused):
    """Differentiable unary ``f(x)``: ``value(x)`` when no gradient is
    recorded, else ``fused(x) -> (y, slope)`` with the slope saved for the
    backward pass (the JVP rule of the JAX package's table functions)."""

    def f(x):
        if torch.is_grad_enabled() and x.requires_grad:
            return _SlopeRule.apply(x, fused)
        return value(x)

    return f


def make_table_fn(jt: TorchTable, *, use_kernel: bool = False, exact_d1=None,
                  extrapolate: bool = False):
    """Differentiable unary ``f(x)`` from a table.

    Tangent rule: the table slope by default (what the hardware computes),
    ``exact_d1`` (a torch callable) for the analytic derivative.
    ``use_kernel=True`` (``table_pallas`` mode) routes through the CUDA
    kernels: the value kernel without a gradient, the fused value + slope
    kernel under one; ``use_kernel=False`` (``table_ref``) is the plain
    version.  With ``exact_d1`` the forward is the value path and the slope
    ``exact_d1(x)``.
    """
    if use_kernel:
        from repro_torch.kernels.table_grad import table_lookup_grad
        from repro_torch.kernels.table_lookup import table_lookup

        value = lambda x: table_lookup(jt, x, extrapolate=extrapolate)
        fused = lambda x: table_lookup_grad(jt, x, extrapolate=extrapolate)
    else:
        value = lambda x: eval_table_ref(jt, x, extrapolate=extrapolate)
        fused = lambda x: (value(x), eval_table_slope(jt, x, extrapolate=extrapolate))
    if exact_d1 is not None:
        fused = lambda x: (value(x), exact_d1(x))
    return slope_rule(value, fused)
