"""Nonlinearity backend of the port: every elementary function the model
evaluates runs ``exact`` (PyTorch transcendentals), ``table_ref`` (the
paper-faithful per-function table, plain PyTorch), ``table_pallas`` (the same
tables through the CUDA table kernels), ``table_pack`` (ONE packed
multi-function artifact + one CUDA kernel for the whole network),
``quant_pack`` (the pack with int8/int16 codes dequantized on read),
``poly_pack`` (the planner's degree-1..3 coefficient pack, Horner on read),
the ``routed_pack`` / ``routed_quant_pack`` / ``routed_poly_pack`` variants,
which serve the f32, quantized and polynomial packs through per-row DYNAMIC
fn_id dispatch (the member is a device operand of one kernel, so
mixed-function batches — see :meth:`ApproxConfig.routed_fn` — and every
member's unary share it), ``sharded_pack`` (the f32 pack's values cut into
``pack_shards`` slices, each shard's masked contribution summed on one
device), the ``folded_pack`` / ``folded_routed_pack``
variants (RangeFold, :mod:`repro_torch.approx.range_fold`), which put a range
reduction in front of the f32 pack so ``sin`` / ``cos`` / ``exp`` / ``log``
are served over the whole finite f32 domain from small canonical-interval
core members, or the ``*_ref`` plain PyTorch version of each.  Configured per
model via :class:`ApproxConfig`, whose fields and defaults are the JAX
package's.  Every table function is differentiable: its tangent is the table
slope, or the registry's analytic derivative with ``exact_grad``.  TableFlash
(``attn_table``) always serves the attention exponent, and ``rope_table`` the
rotary sin/cos (through the folded trig members), from the f32 pack, in the
sharded modes too.  ``place_packs(mesh)`` places the sharded pack over a
mesh's 'model' axis (one values slice a rank); the closures built under
``use_sharding(mesh)`` then hold it and evaluate on the mesh
(``approx.table_pack.eval_sharded_mesh``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core.flow import cached_table
from repro_torch.core.functions import get as get_function
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.sharding import current_mesh

from .range_fold import (FOLDABLE, FOLDED_CORE_MEMBERS, FOLDED_MODES,
                         make_folded_fn, make_folded_routed_unary_fn)
from .table_pack import (PolyTablePack, QuantTablePack, ShardedTablePack,
                         TablePack, build_pack, build_poly_pack, build_quant_pack,
                         build_sharded_pack, make_attn_exp_fn, make_pack_fn,
                         make_poly_pack_fn, make_quant_pack_fn, make_routed_fn,
                         make_routed_unary_fn, make_sharded_pack_fn, member_domain,
                         quant_saturation_counts)
from .torch_table import TorchTable, from_spec, make_table_fn

PACK_MODES = ("table_pack", "table_pack_ref")
QUANT_PACK_MODES = ("quant_pack", "quant_pack_ref")
POLY_PACK_MODES = ("poly_pack", "poly_pack_ref")
ROUTED_MODES = ("routed_pack", "routed_pack_ref", "routed_quant_pack",
                "routed_quant_pack_ref", "routed_poly_pack",
                "routed_poly_pack_ref")
SHARDED_MODES = ("sharded_pack", "sharded_pack_ref")
TABLE_MODES = (("table_ref", "table_pallas") + PACK_MODES + QUANT_PACK_MODES
               + POLY_PACK_MODES + ROUTED_MODES + SHARDED_MODES + FOLDED_MODES)
# modes whose pack artifact is the quantized one (vs the f32 pack)
_QUANT_BACKED = QUANT_PACK_MODES + ("routed_quant_pack", "routed_quant_pack_ref")
# modes whose pack artifact is the planner's polynomial one
_POLY_BACKED = POLY_PACK_MODES + ("routed_poly_pack", "routed_poly_pack_ref")
# modes whose runtime is the CUDA kernels (vs the plain PyTorch versions)
_KERNEL_BACKED = ("table_pallas", "table_pack", "quant_pack", "poly_pack",
                  "routed_pack", "routed_quant_pack", "routed_poly_pack",
                  "sharded_pack", "folded_pack", "folded_routed_pack")


def _check_mode(mode: str) -> None:
    if mode != "exact" and mode not in TABLE_MODES:
        raise ValueError(f"unknown approx mode {mode!r}")


def odd_extension(fn):
    """Extend an odd function's negative-half approximator to all reals.

    The paper tables tanh on its Table-2 interval [-8, 0); gates and softcap
    need both signs.  For odd f, f(x) = s * f(s*x) with s = -sign(x) reuses the
    same table with zero extra entries.  The mirror factor takes x's dtype (the
    JAX package's weak-typed scalar does the same), so a bf16 input stays bf16.
    """

    def extended(x):
        s = torch.where(x >= 0, -1.0, 1.0).to(x.dtype)
        return s * fn(s * x)

    return extended


# Registry tables spanning only the negative half-domain of an odd function:
# every table-mode ``unary`` routes them through ``odd_extension``.
_ODD_HALF_DOMAIN = {"tanh"}

# The function set the model zoo routes through the approx backend (post
# _TABLE_NAME remap): gelu/silu for MLPs, tanh + sigmoid_sym for gates/softcap,
# softplus for SSM dt, exp_neg for the softmax exponent.
DEFAULT_PACK_FUNCTIONS = (
    "gelu", "silu", "tanh", "sigmoid_sym", "softplus", "exp_neg",
)

# One pack per distinct (functions, e_a, algorithm, omega, intervals, device),
# and for the quantized / polynomial packs their own settings too: model
# constructors re-request the same pack for every activation.
_PACK_CACHE: Dict[tuple, TablePack] = {}
_QUANT_PACK_CACHE: Dict[tuple, QuantTablePack] = {}
_POLY_PACK_CACHE: Dict[tuple, PolyTablePack] = {}
_SHARDED_PACK_CACHE: Dict[tuple, ShardedTablePack] = {}
# the packs place_packs placed, keyed by the whole pack's key and the mesh's
# id: a placed pack holds its mesh, so the id is not reused while the entry
# lives, and an off-mesh lookup never sees it
_PLACED_PACKS: Dict[tuple, ShardedTablePack] = {}
# one (sin, cos) closure pair per distinct rope_table configuration and
# device — every layer's rotary shares it
_ROPE_SIN_COS_CACHE: Dict[tuple, Callable] = {}
# one TableFlash exponent closure per distinct attn_table configuration and
# device — every attention layer shares it
_ATTN_EXP_CACHE: Dict[tuple, Callable] = {}

def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) + log1p(exp(-|x|))
    (``F.softplus`` switches to x above a threshold of 20 and orders its
    operations otherwise).  The max splits a tie's gradient as JAX's does, so
    the slope at 0 is sigmoid(0) = 0.5."""
    return torch.maximum(x, x.new_zeros(())) + torch.log1p(torch.exp(-torch.abs(x)))


_EXACT: Dict[str, Callable] = {
    "gelu": lambda x: F.gelu(x),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "sigmoid_sym": torch.sigmoid,
    "softplus": softplus,
    "exp": torch.exp,
    "exp_neg": torch.exp,
    "sin": torch.sin,
    "cos": torch.cos,
    "log": torch.log,
    "erf": torch.erf,
    "relu": F.relu,  # piecewise-linear already; never table'd
    "identity": lambda x: x,
}

# Registry-name remaps for activations whose table spec differs from the exact name.
_TABLE_NAME = {
    "gelu_tanh": "gelu",  # tanh-GELU ~ erf-GELU within 1e-3; table targets exact GELU
    "sigmoid": "sigmoid_sym",
    "exp": "exp_neg",
}

_NEVER_TABLED = {"relu", "identity"}

# Activations with linear asymptotes: extend the edge segments linearly instead of
# saturating.  Flat-asymptote functions (tanh/sigmoid/exp_neg) keep the hardware
# clamp — it IS their asymptote.
_EXTRAPOLATE = {"gelu", "gelu_tanh", "silu", "softplus"}


def _routed_exact(names):
    """Exact-mode routed fallback: row-select over the exact activations."""
    for n in names:
        if not isinstance(n, str) or n not in _EXACT:
            raise KeyError(f"exact-mode routing needs activation names, "
                           f"got {n!r}")
    uniq = tuple(dict.fromkeys(names))

    def f(x):
        sel = (len(names),) + (1,) * (x.dim() - 1)
        y = None
        for u in uniq:
            yu = _EXACT[u](x)
            mask = torch.tensor([n == u for n in names], device=x.device).reshape(sel)
            y = yu if y is None else torch.where(mask, yu, y)
        return y

    return f


@dataclass(frozen=True)
class ApproxConfig:
    """How the model evaluates its elementary functions (the JAX package's
    fields and defaults).

    ``e_a`` is the paper's maximum absolute approximation error; ``algorithm``
    / ``omega`` select the interval splitter.  ``softmax_table`` routes the
    softmax exponent through the exp table; ``attn_table`` (TableFlash) serves
    flash attention's running-softmax exponent from the pack's exp_neg member.
    ``quant_rho`` splits ``e_a`` between interpolation and code rounding in
    the quantized and polynomial packs, ``pack_dtype`` narrows their storage
    widths ('auto' keeps all open), ``pack_budget`` is the polynomial
    pack's byte budget (``None``: the cheapest plan), and ``pack_shards`` how
    many slices the sharded modes cut the f32 pack's values into.
    """

    mode: str = "exact"
    e_a: float = 1e-4
    algorithm: str = "hierarchical"
    omega: float = 0.3
    exact_grad: bool = False
    softmax_table: bool = False
    interval_overrides: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    pack_functions: Tuple[str, ...] = DEFAULT_PACK_FUNCTIONS
    quant_rho: float = 0.9
    pack_dtype: str = "auto"
    pack_budget: Optional[int] = None
    pack_shards: int = 2
    rope_table: bool = False
    attn_table: bool = False

    def table_for(self, name: str, device: DeviceLike = None) -> TorchTable:
        reg_name = _TABLE_NAME.get(name, name)
        lo, hi = self.interval_overrides.get(reg_name, (None, None))
        spec = cached_table(
            reg_name, self.e_a, lo, hi, algorithm=self.algorithm, omega=self.omega
        )
        return from_spec(spec, device)

    def _pack_key(self, dev: torch.device, names=None) -> tuple:
        """(functions, e_a, algorithm, omega, the functions' interval
        overrides, device): what every pack of this config is built from
        (``names`` defaults to ``pack_functions``)."""
        names = tuple(self.pack_functions) if names is None else names
        overrides = tuple(sorted(
            (k, v) for k, v in self.interval_overrides.items() if k in names))
        return (names, self.e_a, self.algorithm, self.omega, overrides, str(dev))

    def pack(self, device: DeviceLike = None) -> TablePack:
        """The ONE multi-function pack this config's activations share, on
        ``device`` (cached per device).  Folded modes (and ``rope_table``)
        extend ``pack_functions`` with the canonical-interval core members
        the range reductions look up (``FOLDED_CORE_MEMBERS``)."""
        dev = resolve_device(device)
        names = tuple(self.pack_functions)
        if self.mode in FOLDED_MODES or self.rope_table:
            names += tuple(c for c in FOLDED_CORE_MEMBERS if c not in names)
        key = self._pack_key(dev, names)
        if key not in _PACK_CACHE:
            _PACK_CACHE[key] = build_pack(
                key[0], self.e_a, algorithm=self.algorithm, omega=self.omega,
                intervals=dict(key[4]), device=dev)
        return _PACK_CACHE[key]

    def quant_pack(self, device: DeviceLike = None) -> QuantTablePack:
        """The shared quantized pack (int8/int16 codes, dequantize-on-read),
        on ``device`` (cached per device)."""
        dev = resolve_device(device)
        key = self._pack_key(dev) + (self.quant_rho, self.pack_dtype)
        if key not in _QUANT_PACK_CACHE:
            _QUANT_PACK_CACHE[key] = build_quant_pack(
                key[0], self.e_a, rho=self.quant_rho, dtype=self.pack_dtype,
                algorithm=self.algorithm, omega=self.omega,
                intervals=dict(key[4]), device=dev)
        return _QUANT_PACK_CACHE[key]

    def poly_pack(self, device: DeviceLike = None) -> PolyTablePack:
        """The shared planner-designed pack (degree-1..3 cells, mixed widths,
        fitted to ``pack_budget`` when set), on ``device`` (cached per
        device)."""
        dev = resolve_device(device)
        key = self._pack_key(dev) + (self.quant_rho, self.pack_dtype,
                                     self.pack_budget)
        if key not in _POLY_PACK_CACHE:
            _POLY_PACK_CACHE[key] = build_poly_pack(
                key[0], self.e_a, budget_bytes=self.pack_budget,
                rho=self.quant_rho, dtype=self.pack_dtype,
                algorithm=self.algorithm, omega=self.omega,
                intervals=dict(key[4]), device=dev)
        return _POLY_PACK_CACHE[key]

    def _sharded_key(self, dev: torch.device) -> tuple:
        return self._pack_key(dev) + (self.pack_shards,)

    def sharded_pack(self, device: DeviceLike = None, mesh=None) -> ShardedTablePack:
        """The shared pack with its values cut ``pack_shards`` ways, on
        ``device`` (cached per device).  Off the mesh: every shard lives on
        ``device`` and the contributions are summed there.  The pack
        :meth:`place_packs` placed over ``mesh`` (default: the mesh
        ``use_sharding`` binds) when there is one: this rank's one slice."""
        dev = resolve_device(device)
        key = self._sharded_key(dev)
        if mesh is None:
            mesh = current_mesh()
        if mesh is not None and (key, id(mesh)) in _PLACED_PACKS:
            return _PLACED_PACKS[key, id(mesh)]
        if key not in _SHARDED_PACK_CACHE:
            _SHARDED_PACK_CACHE[key] = build_sharded_pack(
                key[0], self.e_a, self.pack_shards, algorithm=self.algorithm,
                omega=self.omega, intervals=dict(key[4]), device=dev)
        return _SHARDED_PACK_CACHE[key]

    def place_packs(self, mesh) -> None:
        """Place this config's sharded pack over ``mesh`` (the reference's
        ``place_packs``): this rank's ONE values slice
        (``parallel.sharding.place_sharded_pack``), which every activation
        closure built AFTER this call under ``use_sharding(mesh)`` holds, so
        that it evaluates on the mesh.  Call it before constructing the model
        (``build_model(cfg, mesh=...)`` does, and binds the mesh while it
        builds).  Closures built off the binding keep the whole pack.  No-op
        for non-sharded modes, ``mesh=None``, or a 'model' axis whose width
        differs from ``pack_shards``; idempotent."""
        if mesh is None or self.mode not in SHARDED_MODES:
            return
        from repro_torch.parallel.sharding import (axis_sizes, mesh_device,
                                                   place_sharded_pack)

        if axis_sizes(mesh).get("model") != self.pack_shards:
            return
        dev = mesh_device(mesh)
        key = self._sharded_key(dev)
        if (key, id(mesh)) not in _PLACED_PACKS:
            _PLACED_PACKS[key, id(mesh)] = place_sharded_pack(
                self.sharded_pack(dev, mesh), mesh)

    def _pack_for_mode(self, device: DeviceLike = None):
        if self.mode in _POLY_BACKED:
            return self.poly_pack(device)
        if self.mode in _QUANT_BACKED:
            return self.quant_pack(device)
        if self.mode in SHARDED_MODES:
            return self.sharded_pack(device)
        return self.pack(device)

    def unary(self, name: str, device: DeviceLike = None) -> Callable:
        """The activation callable for this config, its tables on ``device``.
        Differentiable in every mode: table modes through
        ``torch_table.slope_rule`` (table slope, or the registry's ``d1f``
        with ``exact_grad``)."""
        _check_mode(self.mode)
        if self.mode == "exact" or name in _NEVER_TABLED:
            return _EXACT[name]
        reg_name = _TABLE_NAME.get(name, name)
        if self.mode in FOLDED_MODES and name in FOLDABLE:
            # foldable names keep their full-range identity: "exp" stays exp
            # (the 2^k split covers all of f32, no exp_neg remap)
            reg_name = name
        extrapolate = name in _EXTRAPOLATE
        exact_d1 = None
        if self.exact_grad:
            exact_d1 = partial(get_function(reg_name).d1f, xp=torch)
        use_kernel = self.mode in _KERNEL_BACKED
        if self.mode in (PACK_MODES + QUANT_PACK_MODES + POLY_PACK_MODES
                         + ROUTED_MODES + SHARDED_MODES + FOLDED_MODES):
            pack = self._pack_for_mode(device)
            foldable = self.mode in FOLDED_MODES and reg_name in FOLDABLE
            if reg_name not in pack.names and not foldable:
                # a foldable member needs only its core members in the pack
                # (pack() appends them)
                raise KeyError(
                    f"{reg_name!r} is not in pack_functions={pack.names}; add it "
                    f"to ApproxConfig.pack_functions to serve it from the pack")
            if self.mode in FOLDED_MODES:
                # full-f32-range sin/cos/exp/log; the other members fall
                # through to the plain pack paths inside make_folded_*
                make = (make_folded_routed_unary_fn
                        if self.mode.startswith("folded_routed") else make_folded_fn)
            elif self.mode in ROUTED_MODES:
                # dynamic dispatch with one id: the member is a device
                # operand, so every unary shares one kernel
                make = make_routed_unary_fn
            elif self.mode in SHARDED_MODES:
                # one launch a call over the S shards, their contributions
                # summed on the card (the value, and the value + slope)
                make = make_sharded_pack_fn
            else:
                make = (make_poly_pack_fn if self.mode in POLY_PACK_MODES
                        else make_quant_pack_fn if self.mode in QUANT_PACK_MODES
                        else make_pack_fn)
            f = make(pack, reg_name, use_kernel=use_kernel, exact_d1=exact_d1,
                     extrapolate=extrapolate)
        else:
            f = make_table_fn(self.table_for(name, device), use_kernel=use_kernel,
                              exact_d1=exact_d1, extrapolate=extrapolate)
        if reg_name in _ODD_HALF_DOMAIN:
            # the registry table spans [-lo, 0): mirror it so gates/softcap get
            # the full symmetric domain
            f = odd_extension(f)
        return self._maybe_instrument_unary(f, name, reg_name, device)

    def _maybe_instrument_unary(self, f, name: str, reg_name: str,
                                device: DeviceLike = None):
        """Device-side approximation telemetry, decided at closure-BUILD time
        (the reference's ``_maybe_instrument_unary``).

        With ``obs.device_telemetry_enabled()`` when ``unary`` builds the
        callable, each call counts out-of-domain clamp/extrapolation hits
        (and, on quant-backed packs, saturated endpoint codes) into the
        global registry: a probe on a detached f32 copy of x under
        ``no_grad``, summed on x's device with no host sync; the values
        returned are ``f(x)``'s own.  Off — the default — ``f`` itself is
        returned: no wrapper, no extra operator.  Flipping the flag after a
        model is built has no effect on that model.
        """
        if not obs.device_telemetry_enabled():
            return f
        quant_pack = None
        if self.mode in FOLDED_MODES and reg_name in FOLDABLE:
            # folded members serve the entire finite f32 domain: the fold
            # maps every input into its core member's interval
            lo, hi = float("-inf"), float("inf")
        elif self.mode in (PACK_MODES + QUANT_PACK_MODES + POLY_PACK_MODES
                           + ROUTED_MODES + SHARDED_MODES + FOLDED_MODES):
            pack = self._pack_for_mode(device)
            lo, hi = member_domain(pack, reg_name)
            if isinstance(pack, QuantTablePack):
                quant_pack = pack
        else:
            # the table's outer boundaries, read on the host once, at build
            b = self.table_for(name, "cpu").boundaries
            lo, hi = float(b[0]), float(b[-1])
        mirror = reg_name in _ODD_HALF_DOMAIN
        names = {k: f"approx.{k}.{reg_name}"
                 for k in ("oob", "lookups", "quant_sat", "quant_gathers")}

        def instrumented(x):
            reg = obs.get_registry()
            with torch.no_grad():
                xf = x.detach().to(torch.float32)
                # half-domain odd members evaluate at -|x| (odd_extension):
                # probe the mirrored input, so the domain is (lo, -lo)
                probe = torch.minimum(xf, -xf) if mirror else xf
                reg.counter(names["oob"]).add(((probe < lo) | (probe >= hi)).sum())
                reg.counter(names["lookups"]).add(xf.numel())
                if quant_pack is not None and xf.numel():
                    sat, total = quant_saturation_counts(quant_pack, reg_name, probe)
                    reg.counter(names["quant_sat"]).add(sat)
                    reg.counter(names["quant_gathers"]).add(total)
            return f(x)

        return instrumented

    def routed_fn(self, fns, device: DeviceLike = None, *,
                  extrapolate=None) -> Callable:
        """Per-row dynamic dispatch: ``f(x)`` applies ``fns[i]`` to row i of
        ``x`` (leading axis) in ONE call — MoE-style routed activations —
        with the tables on ``device``.

        In table modes this is served by the routed kernels of this mode's
        pack (their plain versions in the ``*_ref`` modes and ``table_ref``),
        one launch whatever the routing; ``exact`` mode falls back to a
        row-select over the exact transcendentals.  ``fns`` are activation
        names (remapped like :meth:`unary`: ``sigmoid`` -> ``sigmoid_sym``,
        ``exp`` -> ``exp_neg``) or member ids; half-domain odd members (tanh)
        are mirrored per row, so every row sees its full symmetric domain.
        ``extrapolate`` defaults to each member's own edge rule.
        """
        names = tuple(_TABLE_NAME.get(f, f) if isinstance(f, str) else f
                      for f in fns)
        if self.mode == "exact":
            return _routed_exact(names)
        _check_mode(self.mode)
        pack = self._pack_for_mode(device)
        for n in names:
            if isinstance(n, str) and n not in pack.names:
                raise KeyError(
                    f"{n!r} is not in pack_functions={pack.names}; add it to "
                    f"ApproxConfig.pack_functions to route to it")
        if extrapolate is None:
            extrapolate = tuple(n in _EXTRAPOLATE for n in pack.names)
        f = make_routed_fn(pack, names, use_kernel=self.mode in _KERNEL_BACKED,
                           extrapolate=extrapolate)
        odd = np.asarray([isinstance(n, str) and n in _ODD_HALF_DOMAIN
                          for n in names])
        if odd.any():
            odd_rows = torch.from_numpy(odd).to(pack.device)  # once, at build

            def routed_odd(x, _f=f):
                # per-row odd_extension: mirror only the half-domain rows (s
                # is +-1 and piecewise constant, so the gradient flows
                # through f's slope rule untouched)
                m = odd_rows.reshape((len(names),) + (1,) * (x.dim() - 1))
                s = torch.where(m & (x >= 0), -1.0, 1.0).to(x.dtype)
                return s * _f(s * x)

            f = routed_odd
        return self._maybe_instrument_routed(f, names, pack)

    def _maybe_instrument_routed(self, f, names, pack):
        """Routed-dispatch telemetry, decided at closure-build time like
        :meth:`_maybe_instrument_unary`: each call adds this routing's static
        per-member row counts (host ints) to ``approx.routed.<member>`` —
        across calls the counters form the fn_id dispatch histogram."""
        if not obs.device_telemetry_enabled():
            return f
        counts: Dict[str, int] = {}
        for n in names:
            key = n if isinstance(n, str) else pack.names[int(n)]
            counts[key] = counts.get(key, 0) + 1

        def instrumented(x):
            reg = obs.get_registry()
            for member, rows in counts.items():
                reg.counter(f"approx.routed.{member}").add(rows)
            return f(x)

        return instrumented

    def softmax(self, x: torch.Tensor, axis: int = -1, where=None,
                device: DeviceLike = None) -> torch.Tensor:
        """Numerically shifted softmax; exponent optionally via the exp table.
        ``where`` masks entries out (weight 0), as in ``jax.nn.softmax``."""
        if not self.softmax_table or self.mode == "exact":
            if where is None:
                return torch.softmax(x, dim=axis)
            e = torch.exp(x - torch.amax(x.masked_fill(~where, float("-inf")),
                                         dim=axis, keepdim=True))
            e = torch.where(where, e, 0.0)
            return e / e.sum(dim=axis, keepdim=True)
        exp_fn = self.unary("exp", device)
        masked = x if where is None else x.masked_fill(~where, -1e30)
        m = torch.clamp(torch.amax(masked, dim=axis, keepdim=True), min=-1e30)
        z = x - m.detach()  # the reference's stop_gradient on the shift
        if self.mode in FOLDED_MODES:
            # folded exp serves the whole f32 domain: no address clamp
            e = exp_fn(z)
        else:
            # exp_neg table domain is [-16, 0]; the clamp matches the
            # hardware address saturation
            e = exp_fn(torch.clamp(z, min=-16.0))
        if where is not None:
            e = torch.where(where, e, 0.0)
        return e / e.sum(dim=axis, keepdim=True)

    def rope_sin_cos(self, device: DeviceLike = None) -> Optional[Callable]:
        """Table-served rotary trig: ``None`` (exact sin/cos) unless
        ``rope_table`` is on in a table mode, else ``f(ang) -> (sin, cos)``
        through the folded trig members on ``device`` — the full position
        range by Cody-Waite / Payne-Hanek reduction, served from the SAME f32
        pack as the activations (``pack()`` appends the trig cores), by the
        folded kernels in the kernel modes and their plain versions in the
        others.  ``models.common.apply_rope`` threads it as ``sin_cos``."""
        if not self.rope_table or self.mode == "exact":
            return None
        _check_mode(self.mode)
        dev = resolve_device(device)
        overrides = tuple(sorted(self.interval_overrides.items()))
        key = (self.mode, self.e_a, self.algorithm, self.omega,
               tuple(self.pack_functions), overrides, str(dev))
        if key not in _ROPE_SIN_COS_CACHE:
            pack = self.pack(dev)  # the f32 pack, with the trig cores
            use_kernel = self.mode in _KERNEL_BACKED
            sin_fn = make_folded_fn(pack, "sin", use_kernel=use_kernel)
            cos_fn = make_folded_fn(pack, "cos", use_kernel=use_kernel)
            _ROPE_SIN_COS_CACHE[key] = lambda ang: (sin_fn(ang), cos_fn(ang))
        return _ROPE_SIN_COS_CACHE[key]

    def attn_exp(self, device: DeviceLike = None) -> Optional[Callable]:
        """TableFlash exponent: ``None`` (exact exp in flash attention) unless
        ``attn_table`` is on in a table mode, else ``f(z) -> exp(z)`` for
        z <= 0 through the pack's ``exp_neg`` member — underflow-to-zero tail
        below lo, CUDA kernel or plain version by mode, always served from
        the SAME f32 pack artifact as the activations."""
        if not self.attn_table or self.mode == "exact":
            return None
        _check_mode(self.mode)
        names = tuple(self.pack_functions)
        if "exp_neg" not in names:
            raise KeyError(
                f"attn_table needs 'exp_neg' in pack_functions={names}; add "
                f"it to ApproxConfig.pack_functions to serve TableFlash")
        dev = resolve_device(device)
        overrides = tuple(sorted(self.interval_overrides.items()))
        key = (self.mode, self.e_a, self.algorithm, self.omega, names,
               overrides, str(dev))
        if key not in _ATTN_EXP_CACHE:
            _ATTN_EXP_CACHE[key] = make_attn_exp_fn(
                self.pack(dev), use_kernel=self.mode in _KERNEL_BACKED)
        return self._maybe_instrument_attn_exp(_ATTN_EXP_CACHE[key], dev)

    def _maybe_instrument_attn_exp(self, f, device: torch.device):
        """TableFlash clamp telemetry, decided at closure-build time like
        :meth:`_maybe_instrument_unary` (off: the cached closure itself; the
        wrapper is never stored in the cache).

        Counts only ``z < lo`` underflow-to-zero events into
        ``approx.oob.attn_exp``: z = 0 is the running max's own argument in
        every row and is in-domain.  The wrapper advertises
        ``wants_count_mask``; flash attention then passes ``count_mask``,
        False on the KV_PAD chunk-padding keys — a genuine ``k_pos == -1``
        empty cache slot still counts its underflow, a padding lane does not
        — and the lookups counted are the mask's sum.
        """
        if not obs.device_telemetry_enabled():
            return f
        lo, _ = member_domain(self.pack(device), "exp_neg")

        def instrumented(x, count_mask=None):
            reg = obs.get_registry()
            with torch.no_grad():
                under = x.detach().to(torch.float32) < lo
                if count_mask is None:
                    total = x.numel()
                else:
                    under = under & count_mask
                    total = count_mask.expand(x.shape).sum()
                reg.counter("approx.oob.attn_exp").add(under.sum())
                reg.counter("approx.lookups.attn_exp").add(total)
            return f(x)

        instrumented.wants_count_mask = True
        return instrumented

