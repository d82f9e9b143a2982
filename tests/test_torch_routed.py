"""The port's routed dispatch (per-row fn_id over the f32 and the quantized
pack) against the JAX reference, on the same numpy inputs.

Contract (tolerances stated with their reason):

* the routing operands (``routing_scalars``, the layouts' offsets) are the
  reference's, value for value;
* plain versions (``eval_routed_ref`` / ``_slope``, ``eval_routed_quant_ref``
  / ``_slope`` and the CPU wrappers): bitwise equal to the reference's EAGER
  oracles, which round every op on its own, and row for row to the port's
  static dispatch of the row's member, on mixed rows with extrapolation on,
  off and per member, in f32 and bf16.  Slopes are compared on finite inputs
  (the eager oracle's gathers do not clamp a non-finite address);
* against the reference's routed Pallas kernels in interpret mode (as its
  own tests run them on the CPU), where XLA contracts FMAs: the f32 pack
  within 1 ULP at the lerp's scale ``max(|y0|, |y1|, |t (y1 - y0)|, |y|)``
  and its slope within 1 ULP of itself (the bound of
  tests/test_torch_pack.py); the quantized pack within 4 ULP of the largest
  intermediate of the element's evaluation, times ``1 + |t - clip(t, 0, 1)|``
  past the cell grid, and its slope within 4 ULP of its largest term (the
  bounds of tests/test_torch_quant_poly.py, for the reasons given there);
* ``torch.Tensor`` ids (a router's output) are clamped to ``[0, F-1]`` and
  never validated; names, ints and sequences are validated (``KeyError``
  listing the members), shapes and flag counts raise ``ValueError``;
* gradients through ``make_routed_fn`` / ``make_routed_unary_fn`` /
  ``ApproxConfig``: exactly ``slope * dy``, and bitwise equal to the
  reference's VJP of its ``custom_jvp`` in its plain mode (one product per
  element on both sides);
* inputs are normal floats or zero: XLA on the CPU flushes subnormal inputs
  to zero, PyTorch and the CUDA kernels do not (the card tests keep them);
* model: reduced stablelm (2 layers, d=64, f32 compute) serves the mixed-EOS
  queue token-identical to the JAX ContinuousEngine in the same routed mode,
  and 2 train steps (accum 2) give losses within 1e-4 relative and grad
  norms within 1e-3 of the reference's (the bounds of
  tests/test_torch_train.py, for the reasons given there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import ApproxConfig as JApprox
from repro.approx import table_pack as tp_ref
from repro.core import packing as j_packing
from repro.core import quantize as j_quantize
from repro.kernels.routed_pack_lookup import (routed_pack_grad_pallas,
                                              routed_pack_lookup_pallas,
                                              routed_quant_pack_grad_pallas,
                                              routed_quant_pack_lookup_pallas)
from repro_torch.approx import (ROUTED_MODES, SHARDED_MODES, TABLE_MODES, ApproxConfig,
                                table_pack)
from repro_torch.core import packing, quantize
from repro_torch.kernels import _lib
from repro_torch.kernels import routed_pack_lookup as R
from repro_torch.kernels import table_pack_lookup as K
from tests.test_torch_pack import assert_within_ulp, lerp_scale
from tests.test_torch_quant_poly import _quant_scale, _quant_slope_scale, ulps

NAMES = ("gelu", "silu", "tanh", "sigmoid_sym", "softplus", "exp_neg")
EA = 1e-4  # stablelm-3b's own settings: e_a 1e-4, omega 0.2
OMEGA = 0.2
# the reference's tests/test_routed_pack.py mixed_width_pack: forced int8 and
# int16 members in one pack
MIXED_WIDTHS = (("gelu", "int8"), ("tanh", "int16"), ("log", "int16"),
                ("sigmoid", "int8"))
COLS = 600
SLOTS = ("gelu", "silu", "tanh", "sigmoid", "softplus", "exp")


# --------------------------------------------------------------------------------------
# packs, built once per module on both sides
# --------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f32():
    return (tp_ref.build_pack(NAMES, EA, omega=OMEGA),
            table_pack.build_pack(NAMES, EA, omega=OMEGA, device="cpu"))


@pytest.fixture(scope="module")
def quant():
    return (tp_ref.build_quant_pack(NAMES, EA, omega=OMEGA),
            table_pack.build_quant_pack(NAMES, EA, omega=OMEGA, device="cpu"))


@pytest.fixture(scope="module")
def mixed():
    j = j_packing.quant_pack_layout(
        [j_quantize.plan_quant_member(n, EA, dtype=d) for n, d in MIXED_WIDTHS])
    t = packing.quant_pack_layout(
        [quantize.plan_quant_member(n, EA, dtype=d) for n, d in MIXED_WIDTHS])
    return tp_ref.from_quant_layout(j), table_pack.from_quant_layout(t, "cpu"), j, t


KINDS = ("f32", "quant", "mixed")


def _packs(kind, request):
    got = request.getfixturevalue(kind)
    return got[0], got[1]


def _ports(kind):
    """(port plain value, slope, wrapper value, wrapper grad, reference eager
    value, slope, interpret kernel value, grad) of a pack kind."""
    if kind == "f32":
        return (table_pack.eval_routed_ref, table_pack.eval_routed_slope,
                R.routed_pack_lookup, R.routed_pack_grad,
                tp_ref.eval_routed_ref, tp_ref.eval_routed_slope,
                routed_pack_lookup_pallas, routed_pack_grad_pallas)
    return (table_pack.eval_routed_quant_ref, table_pack.eval_routed_quant_slope,
            R.routed_quant_pack_lookup, R.routed_quant_pack_grad,
            tp_ref.eval_routed_quant_ref, tp_ref.eval_routed_quant_slope,
            routed_quant_pack_lookup_pallas, routed_quant_pack_grad_pallas)


def _static(kind):
    """The port's static (value, slope) plain versions of a pack kind."""
    if kind == "f32":
        return table_pack.eval_pack_ref, table_pack.eval_pack_slope
    return table_pack.eval_quant_pack_ref, table_pack.eval_quant_pack_slope


def _bounds(pack, fid):
    if isinstance(pack, table_pack.TablePack):
        return pack.boundaries[fid, : pack.n_intervals[fid] + 1].numpy()
    bo = pack.bounds_offset(fid)
    return pack.boundaries[bo: bo + pack.n_intervals[fid] + 1].numpy()


def row_inputs(pack, fid, seed, cols=COLS):
    """One row for member ``fid``: every boundary and its f32 neighbours, the
    specials, then uniform draws over the domain +- 3 (subnormals removed,
    see the docstring)."""
    lo, hi = pack.domains[fid]
    b = _bounds(pack, fid)
    head = np.concatenate([b, np.nextafter(b, np.float32(np.inf)),
                           np.nextafter(b, np.float32(-np.inf)),
                           [np.inf, -np.inf, np.nan, -2e38, 2e38, 0.0, -0.0, lo, hi]])
    rng = np.random.default_rng(seed)
    x = np.concatenate([head, rng.uniform(lo - 3.0, hi + 3.0, cols)])[:cols]
    x = x.astype(np.float32)
    return np.where((x != 0) & (np.abs(x) < np.finfo(np.float32).tiny), 0.0, x)


def mixed_rows(pack, seed=0, cols=COLS):
    """Rows cycling over the members (2F + 1 rows), each over its own
    member's domain and edges; returns (ids, x)."""
    F = pack.n_functions
    ids = [(3 * r + 1) % F for r in range(2 * F + 1)]
    x = np.stack([row_inputs(pack, f, seed + r, cols) for r, f in enumerate(ids)])
    return ids, x


FLAGS = ("off", "on", "per_member")


def _flags(pack, which):
    if which == "per_member":
        return tuple(f % 2 == 0 for f in range(pack.n_functions))
    return which == "on"


def assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert int(ulps(got, want).max()) == 0


def image_sections(tp, sections, layout, planes, groups):
    """A quantized or polynomial pack whose ``planes`` and code ``groups``
    are all read from the sections of its staging image (``tp.image``, what
    a block of its kernels stages on the card where it fits), nothing of the
    pack outside them; the image's routing sections (the first of
    ``sections``) must be the routing operands.  ``layout``: (section
    starts, image words)."""
    starts, words = layout
    assert tp.image.dtype == torch.int32 and tp.image.shape == (words,)
    raw = tp.image.view(torch.uint8)

    def section(name, like):
        at = 4 * starts[name]
        return raw[at: at + like.numel() * like.element_size()].view(like.dtype)

    for name, r in zip(sections, tp.routing_scalars()):
        assert torch.equal(section(name, r), r), name
    rebuilt = dataclasses.replace(
        tp, **{p: section(p, getattr(tp, p)) for p in planes + groups})
    for p in planes + groups:
        assert torch.equal(getattr(rebuilt, p), getattr(tp, p)), p
    return rebuilt


def f32_image_pack(tp):
    """The f32 pack read from its staging image (``tp.image``): each
    member's row from its start (``tp.image_rows``, member_image_layout) over
    its real sub-intervals, padded as the pack's rows (+inf boundaries) with
    NaN in the other planes' padding, which no lookup may read, and the
    image's values only."""
    image, m_img = tp.image
    starts, v_at = table_pack.member_image_layout(tp.n_intervals)
    assert tp.image_rows.dtype == torch.int32
    assert tp.image_rows.tolist() == list(starts)
    assert image.dtype == torch.float32 and image.numel() % 4 == 0
    assert v_at + m_img <= image.numel() < v_at + m_img + 4
    F, n_max = tp.n_functions, tp.n_max
    b = torch.full((F, n_max + 1), float("inf"))
    rows = [torch.full((F, n_max), float("nan")) for _ in range(3)]
    for f, (at, n) in enumerate(zip(starts, tp.n_intervals)):
        b[f, : n + 1] = image[at: at + n + 1]
        for k, plane in enumerate(rows):
            plane[f, :n] = image[at + n + 1 + k * n: at + 2 * n + 1 + k * n]
    return dataclasses.replace(tp, boundaries=b, inv_delta=rows[0], base=rows[1],
                               seg_count=rows[2], values=image[v_at: v_at + m_img])


def cell_midpoints(pack, fid):
    """The middle of every cell of member ``fid`` (f32): a lookup there
    reads the cell's pair of values or codes."""
    n = pack.n_intervals[fid]
    if isinstance(pack, table_pack.TablePack):
        b, invd, segs = (pack.boundaries[fid, : n + 1], pack.inv_delta[fid, :n],
                         pack.seg_count[fid, :n])
    else:
        bo, lo = pack.bounds_offset(fid), pack.lane_offset(fid)
        b, invd, segs = (pack.boundaries[bo: bo + n + 1], pack.inv_delta[lo: lo + n],
                         pack.seg_count[lo: lo + n])
    return np.concatenate([
        float(b[j]) + (np.arange(int(segs[j])) + 0.5) / float(invd[j])
        for j in range(n)]).astype(np.float32)


def assert_image_covers_every_read(tp, rebuilt, value, slope, static=False):
    """``rebuilt`` (the pack read from its staging image alone) gives the
    plain ``value`` and ``slope`` with ``tp``'s bits, extrapolation off, on
    and per member: routed over mixed rows, or (``static``: ``value(pack,
    fid, x, *, extrapolate)``) each member over a row of its own."""
    F = tp.n_functions
    mids = [cell_midpoints(tp, f) for f in range(F)]
    width = max(m.size for m in mids)
    # a row a member: its edges, then a point in each of its cells (so every
    # value or code it holds is read), then (routed) the mixed rows
    ids = list(range(F))
    x = np.stack([np.concatenate([row_inputs(tp, f, 5 + f, 128), np.resize(m, width)])
                  for f, m in enumerate(mids)])
    if not static:
        more, xm = mixed_rows(tp, seed=5, cols=128 + width)
        ids, x = ids + more, np.concatenate([x, xm])
    xt = torch.from_numpy(x)
    ft = torch.from_numpy(np.where(np.isfinite(x), x, 0.0).astype(np.float32))
    for flags in FLAGS:
        ex = _flags(tp, flags)
        for fn, xin in ((value, xt), (slope, ft)):
            if not static:
                assert_bitwise(fn(rebuilt, ids, xin, extrapolate=ex).numpy(),
                               fn(tp, ids, xin, extrapolate=ex).numpy())
                continue
            for f in ids:
                e = ex if isinstance(ex, bool) else ex[f]
                assert_bitwise(fn(rebuilt, f, xin[f], extrapolate=e).numpy(),
                               fn(tp, f, xin[f], extrapolate=e).numpy())


# --------------------------------------------------------------------------------------
# routing operands and id handling
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_routing_scalars_match_reference(kind, request):
    jp, tp = _packs(kind, request)
    got, want = tp.routing_scalars(), jp.routing_scalars()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.device == tp.device
        np.testing.assert_array_equal(g.numpy(), w)
    assert tp.routing_scalars() is tp.routing_scalars()  # built once, with the pack


def test_layout_offsets_match_reference(mixed):
    *_, j, t = mixed
    np.testing.assert_array_equal(t.bounds_offsets, j.bounds_offsets)
    np.testing.assert_array_equal(t.lane_offsets, j.lane_offsets)
    assert t.bounds_offsets.dtype == t.lane_offsets.dtype == np.int32


@pytest.mark.parametrize("kind, reader", [
    ("f32", "routed"), ("quant", "routed"), ("mixed", "routed"), ("quant", "static"),
    ("mixed", "static")], ids=list(KINDS) + ["quant-static", "mixed-static"])
def test_staging_image_covers_every_read(kind, reader, request):
    """The f32 pack's staging image (``TablePack.image``: the members' rows
    over their real sub-intervals at ``image_rows``, then the values) and
    the quantized pack's (``QuantTablePack.image``), which the routed quant
    kernels and the static ones (``reader="static"``: each member over a
    row of its own) stage where it fits."""
    _, tp = _packs(kind, request)
    if kind == "f32":
        assert_image_covers_every_read(tp, f32_image_pack(tp), table_pack.eval_routed_ref,
                                       table_pack.eval_routed_slope)
        return
    rebuilt = image_sections(
        tp, table_pack.QUANT_IMAGE_SECTIONS,
        table_pack.quant_image_layout(tp.n_functions, tp.inv_delta.shape[0],
                                      tp.codes8.shape[0], tp.codes16.shape[0]),
        ("boundaries", "inv_delta", "base", "seg_count", "scale", "zero", "ramp"),
        ("codes8", "codes16"))
    if reader == "routed":
        assert_image_covers_every_read(tp, rebuilt, table_pack.eval_routed_quant_ref,
                                       table_pack.eval_routed_quant_slope)
    else:
        assert_image_covers_every_read(tp, rebuilt, table_pack.eval_quant_pack_ref,
                                       table_pack.eval_quant_pack_slope, static=True)


@pytest.mark.parametrize("kind", ["f32", "quant"])
def test_resolve_fn_ids_and_flags_errors(kind, request):
    jp, tp = _packs(kind, request)
    with pytest.raises(KeyError, match=r"'nope' not in pack \('gelu'"):
        table_pack.resolve_fn_ids(tp, ["gelu", "nope"], 2)
    with pytest.raises(KeyError, match="out of range.*members"):
        table_pack.resolve_fn_ids(tp, [0, 99], 2)
    with pytest.raises(KeyError, match="out of range"):  # numpy arrays are validated
        table_pack.resolve_fn_ids(tp, np.asarray([0, -1]), 2)
    with pytest.raises(ValueError, match="does not match the 2 leading rows"):
        table_pack.resolve_fn_ids(tp, [0, 1, 2], 2)
    with pytest.raises(ValueError, match="does not match"):
        table_pack.resolve_fn_ids(tp, torch.zeros(3, dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="one flag per member"):
        table_pack.routed_extr_flags(tp, (True, False))
    with pytest.raises(ValueError, match="leading row axis"):
        R.routed_pack_lookup(tp, "gelu", torch.tensor(1.0)) if kind == "f32" else \
            R.routed_quant_pack_lookup(tp, "gelu", torch.tensor(1.0))
    with pytest.raises(KeyError, match="nope"):
        table_pack.make_routed_fn(tp, ["gelu", "nope"])
    ids = table_pack.resolve_fn_ids(tp, "tanh", 3)
    assert ids.dtype == torch.int32 and ids.tolist() == [tp.fn_id("tanh")] * 3
    np.testing.assert_array_equal(table_pack.routed_extr_flags(tp, (True,) * 6),
                                  tp_ref.routed_extr_flags(jp, (True,) * 6))
    # the device flag vector is built once per flag tuple
    a = table_pack.routed_extr_operand(tp, True)
    assert a is table_pack.routed_extr_operand(tp, (True,) * 6)
    assert a.dtype == torch.int32 and a.tolist() == [1] * 6


@pytest.mark.parametrize("kind", ["f32", "quant"])
def test_tensor_ids_are_clamped(kind, request):
    """A router's output (a tensor of ids) is clamped, never validated: row
    by row the static dispatch of the clamped id, as the reference's traced
    ids under jit (here against its eager oracle on the clamped list)."""
    jp, tp = _packs(kind, request)
    value, slope, kval, kgrad, jval, _, _, _ = _ports(kind)
    raw = [1, 0, 10_000, -7, 5, 3]
    clamped = [min(max(i, 0), tp.n_functions - 1) for i in raw]
    x = np.stack([row_inputs(tp, f, seed=f) for f in clamped])
    ids = torch.tensor(raw, dtype=torch.int64)
    assert table_pack.resolve_fn_ids(tp, ids, 6).tolist() == clamped
    want = np.asarray(jval(jp, clamped, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    for got in (value(tp, ids, xt), kval(tp, ids, xt), kgrad(tp, ids, xt)[0],
                table_pack.make_routed_fn(tp, ids)(xt)):
        assert_bitwise(got, want)
    sv, _ = _static(kind)
    for r, f in enumerate(clamped):
        assert_bitwise(value(tp, ids, xt)[r], sv(tp, f, xt[r]))


# --------------------------------------------------------------------------------------
# plain versions against the eager oracles, the static dispatch and the
# interpret-mode kernels
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("kind", KINDS)
def test_bitwise_vs_eager_oracle_and_static(kind, flags, request):
    jp, tp = _packs(kind, request)
    value, slope, kval, kgrad, jval, jslope, _, _ = _ports(kind)
    sv, ss = _static(kind)
    ex = _flags(tp, flags)
    ids, x = mixed_rows(tp, seed=3)
    fin = np.where(np.isfinite(x), x, 0.0).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jval(jp, ids, jnp.asarray(x, jdt),
                               extrapolate=ex)).astype(np.float32)
        want_s = np.asarray(jslope(jp, ids, jnp.asarray(fin, jdt),
                                   extrapolate=ex)).astype(np.float32)
        xt, ft = torch.from_numpy(x).to(dt), torch.from_numpy(fin).to(dt)
        got = value(tp, ids, xt, extrapolate=ex)
        for g in (got, kval(tp, ids, xt, extrapolate=ex),
                  kgrad(tp, ids, xt, extrapolate=ex)[0]):
            assert g.dtype == dt
            assert_bitwise(g.float().numpy(), want)
        got_s = slope(tp, ids, ft, extrapolate=ex)
        for g in (got_s, kgrad(tp, ids, ft, extrapolate=ex)[1]):
            assert g.dtype == dt
            assert_bitwise(g.float().numpy(), want_s)
        flags_of = table_pack.routed_extr_flags(tp, ex)
        for r, f in enumerate(ids):  # row r is the static dispatch of its member
            e = bool(flags_of[f])
            assert_bitwise(got[r].float(), sv(tp, f, xt[r], extrapolate=e).float())
            assert torch.equal(got_s[r], ss(tp, f, ft[r], extrapolate=e))


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("kind", KINDS)
def test_within_ulps_of_interpret_kernels(kind, flags, request):
    jp, tp = _packs(kind, request)
    value, slope, _, _, _, _, kern, kgrad = _ports(kind)
    ex = _flags(tp, flags)
    flags_of = table_pack.routed_extr_flags(tp, ex)
    ids, x = mixed_rows(tp, seed=11, cols=300)
    got = value(tp, ids, torch.from_numpy(x), extrapolate=ex).numpy()
    want = np.asarray(kern(jp, ids, jnp.asarray(x), extrapolate=ex))
    ky, ks = (np.asarray(v) for v in kgrad(jp, ids, jnp.asarray(x), extrapolate=ex))
    np.testing.assert_array_equal(ky, want)  # the reference's two kernels agree
    s_got = slope(tp, ids, torch.from_numpy(x), extrapolate=ex).numpy()
    for r, f in enumerate(ids):
        e = bool(flags_of[f])
        xr = x[r]
        if kind == "f32":
            scale = lerp_scale(tp.boundaries[f], tp.inv_delta[f], tp.base[f],
                               tp.seg_count[f], tp.n_intervals[f], tp.values, xr, e)
            assert_within_ulp(got[r], want[r], scale)
            assert_within_ulp(s_got[r], ks[r], np.zeros_like(xr))
            continue
        scale, amp = _quant_scale(tp, f, xr, e)
        keep = np.isfinite(amp)  # see tests/test_torch_quant_poly.py
        assert (np.isnan(got[r]) == np.isnan(want[r]))[keep].all()
        fin = np.isfinite(got[r]) & np.isfinite(want[r]) & keep
        inf = keep & ~fin & ~np.isnan(got[r])
        assert (got[r][inf] == want[r][inf]).all()
        sc = np.maximum(scale[fin], np.abs(want[r][fin]))
        with np.errstate(over="ignore"):
            tol = 4 * np.spacing(sc.astype(np.float32)) * amp[fin]
        assert (np.abs(got[r][fin] - want[r][fin]) <= tol).all(), tp.names[f]
        xf = np.isfinite(xr)
        ssc = np.maximum(_quant_slope_scale(tp, f, xr[xf]), np.abs(ks[r][xf]))
        assert (np.abs(s_got[r][xf] - ks[r][xf])
                <= 4 * np.spacing(ssc.astype(np.float32))).all(), tp.names[f]


def test_mixed_width_rows_read_their_group(mixed):
    """int8 and int16 members in one call: each row its own width group."""
    jp, tp, *_ = mixed
    assert set(tp.entry_bits) == {8, 16}
    assert tp.codes8.shape[0] > 1 and tp.codes16.shape[0] > 1
    ids = [0, 1, 2, 3, 2, 0]
    x = torch.from_numpy(np.stack([row_inputs(tp, f, seed=f, cols=200) for f in ids]))
    got = R.routed_quant_pack_lookup(tp, ids, x)
    for r, f in enumerate(ids):
        assert_bitwise(got[r], K.quant_pack_lookup(tp, f, x[r]))


def test_shapes_round_trip(f32):
    """Rows are the leading axis and the rest is the row's columns, as the
    reference's tile_routed_rows flattens them."""
    jp, tp = f32
    rng = np.random.default_rng(5)
    for shape in [(1,), (3,), (2, 5), (4, 257), (3, 2, 130), (2, 0), (0, 4)]:
        x = rng.normal(0, 3, shape).astype(np.float32)
        ids = [r % tp.n_functions for r in range(shape[0])]
        got = R.routed_pack_lookup(tp, ids, torch.from_numpy(x))
        assert got.shape == x.shape and got.dtype == torch.float32
        if x.size:
            assert_bitwise(got, tp_ref.eval_routed_ref(jp, ids, jnp.asarray(x)))


# --------------------------------------------------------------------------------------
# closures and gradients
# --------------------------------------------------------------------------------------


def _grad(f, x, dy):
    x = x.clone().requires_grad_(True)
    y = f(x)
    y.backward(dy)
    return y.detach(), x.grad


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_make_routed_fn_values_and_grads(kind, use_kernel, request):
    jp, tp = _packs(kind, request)
    _, _, _, kgrad, _, _, _, _ = _ports(kind)
    ids, x = mixed_rows(tp, seed=21, cols=256)
    x = np.where(np.isfinite(x), x, 0.0).astype(np.float32)
    dy = np.random.default_rng(22).normal(0, 1, x.shape).astype(np.float32)
    ex = tuple(n in ("gelu", "silu", "softplus", "log") for n in tp.names)
    f = table_pack.make_routed_fn(tp, ids, use_kernel=use_kernel, extrapolate=ex)
    for dt in (torch.float32, torch.bfloat16):
        xt, dyt = torch.from_numpy(x).to(dt), torch.from_numpy(dy).to(dt)
        y, g = _grad(f, xt, dyt)
        want_y, s = kgrad(tp, ids, xt, extrapolate=ex)
        assert g.dtype == dt
        assert torch.equal(y, want_y) and torch.equal(g, s * dyt)
        with torch.inference_mode():  # no gradient recorded: the value path
            assert torch.equal(f(xt), want_y)
    jy, vjp = jax.vjp(tp_ref.make_routed_fn(jp, ids, use_pallas=False, extrapolate=ex),
                      jnp.asarray(x))
    y, g = _grad(f, torch.from_numpy(x), torch.from_numpy(dy))
    assert_bitwise(y, jy)
    assert_bitwise(g, vjp(jnp.asarray(dy))[0])


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("kind", ["f32", "quant"])
def test_make_routed_unary_fn_values_and_grads(kind, use_kernel, request):
    jp, tp = _packs(kind, request)
    sv, ss = _static(kind)
    rng = np.random.default_rng(31)
    for fid, name in enumerate(tp.names):
        ex = name in ("gelu", "silu", "softplus")
        lo, hi = tp.domains[fid]
        x = rng.uniform(lo - 2, hi + 2, (3, 7, 40)).astype(np.float32)
        dy = rng.normal(0, 1, x.shape).astype(np.float32)
        f = table_pack.make_routed_unary_fn(tp, name, use_kernel=use_kernel,
                                            extrapolate=ex)
        xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
        y, g = _grad(f, xt, dyt)
        assert y.shape == g.shape == xt.shape
        assert torch.equal(y, sv(tp, fid, xt, extrapolate=ex))
        assert torch.equal(g, ss(tp, fid, xt, extrapolate=ex) * dyt)
        jy, vjp = jax.vjp(tp_ref.make_routed_unary_fn(jp, name, use_pallas=False,
                                                      extrapolate=ex), jnp.asarray(x))
        assert_bitwise(y, jy)
        assert_bitwise(g, vjp(jnp.asarray(dy))[0])
        d1 = lambda v: torch.cos(v)  # exact_d1 is honoured
        f = table_pack.make_routed_unary_fn(tp, name, use_kernel=use_kernel,
                                            exact_d1=d1, extrapolate=ex)
        _, g = _grad(f, xt, dyt)
        assert torch.equal(g, torch.cos(xt) * dyt)


def test_unported_packs_raise(f32):
    """The two pack kinds once refused by routed dispatch, polynomial and
    sharded, are routed now (tests/test_torch_routed_poly.py and
    tests/test_torch_sharded.py hold them to the reference); a non-pack
    still raises."""
    from repro_torch.core import design

    poly = table_pack.from_poly_layout(packing.poly_pack_layout(
        [design.poly_member("gelu", EA, degree=1, bits=32)]), "cpu")
    sharded = table_pack.build_sharded_pack(("gelu", "tanh"), EA, 2, device="cpu")
    x = torch.linspace(-4, 4, 33).reshape(1, -1)
    for make in (table_pack.make_routed_fn, table_pack.make_routed_unary_fn):
        assert torch.equal(make(poly, "gelu")(x), table_pack.eval_poly_pack_ref(
            poly, "gelu", x))
        assert torch.equal(make(sharded, "gelu")(x), table_pack.eval_routed_sharded_ref(
            sharded, ["gelu"], x))
        with pytest.raises(TypeError, match="ShardedTablePack"):
            make(tp_ref.build_sharded_pack(("gelu", "tanh"), EA, 2), "gelu")


# --------------------------------------------------------------------------------------
# ApproxConfig and routed_activation
# --------------------------------------------------------------------------------------


def test_routed_modes_are_ported():
    assert ROUTED_MODES == ("routed_pack", "routed_pack_ref", "routed_quant_pack",
                            "routed_quant_pack_ref", "routed_poly_pack",
                            "routed_poly_pack_ref")
    for mode in ROUTED_MODES + SHARDED_MODES:
        assert mode in TABLE_MODES
    x = torch.linspace(-6, 6, 64).reshape(2, 32)
    for mode in SHARDED_MODES:  # once refused, served now
        a = ApproxConfig(mode=mode, e_a=EA, omega=OMEGA)
        sp = a._pack_for_mode("cpu")
        assert sp is a.sharded_pack("cpu") and sp.n_shards == a.pack_shards == 2
        assert torch.equal(a.unary("silu", "cpu")(x), table_pack.eval_sharded_ref(
            sp, "silu", x, extrapolate=True))
        assert torch.equal(a.routed_fn(("silu", "gelu"), "cpu")(x),
                           table_pack.eval_routed_sharded_ref(
                               sp, ("silu", "gelu"), x, extrapolate=True))
    a = ApproxConfig(mode="routed_quant_pack", e_a=EA, omega=OMEGA)
    assert a._pack_for_mode("cpu") is a.quant_pack("cpu")
    assert dataclasses.replace(a, mode="routed_pack")._pack_for_mode("cpu") is a.pack("cpu")


@pytest.mark.parametrize("mode", ROUTED_MODES)
def test_routed_unary_bitwise_equal_static(mode, f32, quant):
    """A routed unary is the static pack unary, value and gradient, and the
    reference's (eager ``_ref``) unary, remaps and odd extension included."""
    static_mode = {"routed_pack": "table_pack", "routed_pack_ref": "table_pack_ref",
                   "routed_quant_pack": "quant_pack",
                   "routed_quant_pack_ref": "quant_pack_ref",
                   "routed_poly_pack": "poly_pack",
                   "routed_poly_pack_ref": "poly_pack_ref"}[mode]
    rng = np.random.default_rng(41)
    x = np.concatenate([np.linspace(-12, 12, 1001),
                        rng.normal(0, 4, 600)]).astype(np.float32)
    dy = rng.normal(0, 1, x.size).astype(np.float32)
    jmode = mode if mode.endswith("_ref") else mode + "_ref"
    for name in ("gelu", "silu", "tanh", "sigmoid", "exp", "softplus"):
        xi = np.minimum(x, 0.0) if name == "exp" else x
        xt, dyt = torch.from_numpy(xi), torch.from_numpy(dy)
        cfg = ApproxConfig(mode=mode, e_a=EA, omega=OMEGA)
        y, g = _grad(cfg.unary(name, "cpu"), xt, dyt)
        ys, gs = _grad(dataclasses.replace(cfg, mode=static_mode).unary(name, "cpu"),
                       xt, dyt)
        assert torch.equal(y, ys) and torch.equal(g, gs), name
        jy, vjp = jax.vjp(JApprox(mode=jmode, e_a=EA, omega=OMEGA).unary(name),
                          jnp.asarray(xi))
        assert_bitwise(y, jy)
        assert_bitwise(g, vjp(jnp.asarray(dy))[0])


@pytest.mark.parametrize("mode", ROUTED_MODES + ("table_pack", "quant_pack",
                                                 "table_ref", "exact"))
def test_routed_fn_matches_per_slot_unary(mode, f32, quant):
    """One routed call is the per-slot unaries, odd-extended tanh rows
    included; in the table modes also the reference's routed_fn (its eager
    plain mode) value and gradient, bit for bit."""
    cfg = ApproxConfig(mode=mode, e_a=EA, omega=OMEGA)
    rng = np.random.default_rng(51)
    x = rng.normal(0, 3, (len(SLOTS), 2, 64)).astype(np.float32)
    dy = rng.normal(0, 1, x.shape).astype(np.float32)
    f = cfg.routed_fn(SLOTS, "cpu")
    y, g = _grad(f, torch.from_numpy(x), torch.from_numpy(dy))
    for i, n in enumerate(SLOTS):
        yi, gi = _grad(cfg.unary(n, "cpu"), torch.from_numpy(x[i]),
                       torch.from_numpy(dy[i]))
        assert torch.equal(y[i], yi), (mode, n)
        assert torch.equal(g[i], gi), (mode, n)
    assert torch.isfinite(g).all()
    if mode == "exact":
        return
    jmode = ("routed_quant_pack_ref" if "quant" in mode else
             "routed_poly_pack_ref" if "poly" in mode else "routed_pack_ref")
    jf = JApprox(mode=jmode, e_a=EA, omega=OMEGA).routed_fn(SLOTS)
    jy, vjp = jax.vjp(jf, jnp.asarray(x))
    assert_bitwise(y, jy)
    assert_bitwise(g, vjp(jnp.asarray(dy))[0])


def test_routed_fn_errors_and_exact_mode():
    cfg = ApproxConfig(mode="routed_pack", e_a=EA, pack_functions=("gelu",))
    with pytest.raises(KeyError, match="pack_functions"):
        cfg.routed_fn(("gelu", "tanh"), "cpu")
    with pytest.raises(KeyError, match="exact-mode routing needs activation names"):
        ApproxConfig().routed_fn(("gelu", 3))
    with pytest.raises(KeyError, match="exact-mode routing"):
        ApproxConfig().routed_fn(("nope",))
    # the polynomial pack's modes route through its own routed kernels
    poly_cfg = ApproxConfig(mode="poly_pack", e_a=EA, omega=OMEGA,
                            pack_functions=("gelu",))
    xg = torch.linspace(-4, 4, 40).reshape(2, 20)
    assert torch.equal(poly_cfg.routed_fn(("gelu", "gelu"), "cpu")(xg),
                       poly_cfg.unary("gelu", "cpu")(xg))
    # exact mode: a row-select over the exact activations
    x = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(0))
    y = ApproxConfig().routed_fn(("sigmoid", "tanh"))(x)
    # each row is the row of the activation over the whole tensor (CPU
    # vector kernels may round a slice's tail differently)
    assert torch.equal(y[0], torch.sigmoid(x)[0]) and torch.equal(y[1], torch.tanh(x)[1])


@pytest.mark.parametrize("mode", ["routed_pack", "routed_quant_pack"])
def test_attn_exp_in_routed_modes(mode, f32):
    """TableFlash in the routed modes serves the exponent from the f32
    pack, through tableflash_exp (table_pack_grad's slope under a gradient)."""
    a = ApproxConfig(mode=mode, e_a=EA, omega=OMEGA, attn_table=True)
    z = torch.linspace(-30, 0, 301)
    assert torch.equal(a.attn_exp("cpu")(z), K.tableflash_exp_plain(a.pack("cpu"), z))


def test_routed_activation_matches_reference(quant):
    from repro.models.common import routed_activation as j_routed_activation
    from repro_torch.models.common import routed_activation

    x = np.random.default_rng(61).normal(0, 2, (3, 32)).astype(np.float32)
    for mode in ("routed_pack", "routed_quant_pack"):
        got = routed_activation(ApproxConfig(mode=mode, e_a=EA, omega=OMEGA),
                                ["gelu", "tanh", "exp"], "cpu")(torch.from_numpy(x))
        want = j_routed_activation(JApprox(mode=mode + "_ref", e_a=EA, omega=OMEGA),
                                   ["gelu", "tanh", "exp"])(jnp.asarray(x))
        assert got.shape == (3, 32)
        assert_bitwise(got, want)


# --------------------------------------------------------------------------------------
# the model: serving and training against the reference
# --------------------------------------------------------------------------------------


def _pair(mode, attn):
    from repro.models import build_model as j_build_model
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_model, reduced
    from tests.test_archs import reduced as j_reduced

    jm = j_build_model(j_reduced("stablelm-3b").replace(
        compute_dtype="float32",
        approx=JApprox(mode=mode, e_a=EA, omega=OMEGA, attn_table=attn)))
    tm = build_model(reduced("stablelm-3b").replace(
        compute_dtype="float32",
        approx=ApproxConfig(mode=mode, e_a=EA, omega=OMEGA, attn_table=attn)),
        device="cpu")
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_jax(tm.cfg, jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("attn", [False, True])
@pytest.mark.parametrize("mode", ["routed_pack", "routed_quant_pack"])
def test_greedy_tokens_match_reference_engine(mode, attn, f32, quant):
    from repro.serving.engine import ContinuousEngine as JContinuousEngine
    from repro_torch.serving.engine import ContinuousEngine
    from tests.test_serving import mixed_requests

    jm, jp, tm, tp = _pair(mode, attn)
    assert (tm.attn_exp is not None) == attn
    want = JContinuousEngine(jm, jp, batch_size=2, cache_len=64).serve(
        mixed_requests(np.random.default_rng(3), 8))
    _lib.reset_launches()
    got = ContinuousEngine(tm, tp, batch_size=2, cache_len=64).serve(
        mixed_requests(np.random.default_rng(3), 8))
    assert not any(_lib.launches.values())  # CPU tensors: plain versions only
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=f"req {i}")
        assert (b.steps, b.prompt_len) == (a.steps, a.prompt_len)


@pytest.mark.parametrize("mode", ["routed_pack", "routed_quant_pack"])
def test_two_train_steps_match_reference(mode, f32, quant):
    from repro.optim import adamw as j_adamw
    from repro.train.loop import make_train_step as j_make_train_step
    from repro_torch.convert import train_state_from_jax
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train.loop import batch_to, make_train_step

    jm, jp, tm, _ = _pair(mode, True)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=2)
    jstate = {"params": jp, "opt": j_adamw.init(jp), "step": jnp.zeros((), jnp.int32)}
    tstate = train_state_from_jax(tm.cfg, jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(j_make_train_step(jm, j_adamw.AdamWConfig(**opt), accum=2))
    tstep = make_train_step(tm, adamw.AdamWConfig(**opt), accum=2)
    data = SyntheticLM(DataConfig(vocab=tm.cfg.vocab, global_batch=4, seq_len=16))
    jl, tl = [], []
    for s in range(2):
        b = data.batch_at(s)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tmet = tstep(tstate, batch_to(b, "cpu"))
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
        gt, gj = float(tmet["grad_norm"]), float(jmet["grad_norm"])
        assert abs(gt - gj) <= 1e-3 * abs(gj)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert all(np.isfinite(tl))


# --------------------------------------------------------------------------------------
# launchers
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["routed_pack", "routed_quant_pack"])
def test_serve_cli_routed(mode, capsys, f32, quant):
    from repro_torch.launch.serve import main

    res = main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--max-new", "3",
                "--approx-mode", mode, "--attn-table"])
    assert [r.steps for r in res] == [3, 3, 3]
    assert "served 3 requests, 9 tokens on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["routed_pack", "routed_quant_pack"])
def test_train_cli_routed(mode, tmp_path, capsys, f32, quant):
    from repro_torch.launch import train

    out = train.main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "4", "--seq", "16", "--accum", "2",
                      "--approx-mode", mode, "--ckpt-dir", str(tmp_path)])
    assert "done: step=2 loss" in capsys.readouterr().out
    assert all(np.isfinite(out["losses"]))
