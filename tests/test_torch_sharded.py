"""The port's ShardedPack (the f32 pack's values cut into per-shard slices,
summed on one device) against the JAX reference's off-mesh path, on the same
numpy inputs, at stablelm-3b's approx settings (e_a 1e-4, omega 0.2, the six
default members).

Contract (tolerances stated with their reason):

* layout: ``shard_pack_layout`` / ``from_sharded_layout`` give the
  reference's arrays, value for value, for 1, 2, 3, 4 and 8 shards, and the
  reference planner's errors; at 4 shards silu (the model's gate) is split
  over two shards, at 2 no member is;
* plain versions (``eval_sharded_ref`` / ``_slope``, the routed
  ``eval_routed_sharded_ref`` / ``_slope`` and the CPU wrappers): bitwise
  equal to the reference's EAGER oracles, which round every op on their own,
  for every member, extrapolation on and off, at 2 and 4 shards, f32 and
  bf16; and equal, as values, to the port's replicated ``eval_pack_ref`` /
  ``eval_pack_slope`` (the reference's claim at its
  ``kernels/table_pack_lookup.py:648-660``): a shard sum turns an owner's
  -0.0 into +0.0, so the sign of a zero may differ there, and at a NaN x
  (value NaN in both) the extrapolated slope reads entry 0 of the values,
  which is another entry in a slice than in the whole pack;
* against the reference's sharded Pallas kernels in interpret mode (as its
  own tests run them on the CPU), where XLA contracts the lerp into an FMA:
  within 1 ULP at the lerp's scale ``max(|y0|, |y1|, |t (y1 - y0)|, |y|)``,
  slopes within 1 ULP of themselves (the bound of tests/test_torch_pack.py),
  on a few hundred elements (interpret mode is slow);
* gradients through ``make_sharded_pack_fn`` / ``make_routed_fn`` /
  ``ApproxConfig``: exactly ``slope * dy``, and bitwise equal to the
  reference's VJP of its ``custom_jvp`` in its plain mode;
* inputs are normal floats or zero: XLA on the CPU flushes subnormal inputs
  to zero, PyTorch and the CUDA kernels do not (the card tests keep them);
* model: the reduced stablelm (2 layers, d=64, f32 compute) at 4 shards in
  ``sharded_pack_ref`` gives the logits and the greedy tokens of the port's
  ``table_pack_ref`` exactly and the reference's within 1e-4 (the bound of
  tests/test_torch_model.py), and the step-0 loss and grads of
  ``table_pack_ref`` exactly and the reference's within the bounds of
  tests/test_torch_train.py.
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
from repro.kernels.routed_pack_lookup import (sharded_routed_pack_grad_pallas,
                                              sharded_routed_pack_lookup_pallas)
from repro.kernels.table_pack_lookup import (sharded_pack_grad_pallas,
                                             sharded_pack_lookup_pallas,
                                             sharded_pack_slope_pallas,
                                             sharded_shard_contrib_pallas)
from repro_torch.approx import (SHARDED_MODES, TABLE_MODES, ApproxConfig,
                                table_pack)
from repro_torch.core import design, packing
from repro_torch.kernels import _lib
from repro_torch.kernels import routed_pack_lookup as R
from repro_torch.kernels import table_lookup as TL
from repro_torch.kernels import table_pack_lookup as K
from tests.test_torch_pack import (N, _cell_points, assert_bitwise, assert_within_ulp,
                                   inputs, lerp_scale)

NAMES = ("gelu", "silu", "tanh", "sigmoid_sym", "softplus", "exp_neg")
EA = 1e-4
OMEGA = 0.2
SHARDS = (2, 4)
SHARD_COUNTS = (1, 2, 3, 4, 8)  # the fused-sum property's (and the card's)


def _values_equal(got, want):
    """Equal as values, NaN positions matched (+0.0 == -0.0: a shard sum
    turns an owner's -0.0 into +0.0)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


# --------------------------------------------------------------------------------------
# packs, built once per module on both sides
# --------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layouts():
    from repro.core.flow import cached_table as j_cached
    from repro_torch.core.flow import cached_table

    j = j_packing.pack_layout([j_cached(n, EA, omega=OMEGA) for n in NAMES])
    t = packing.pack_layout([cached_table(n, EA, omega=OMEGA) for n in NAMES])
    return j, t


@pytest.fixture(scope="module")
def f32(layouts):
    return table_pack.from_layout(layouts[1], "cpu")


@pytest.fixture(scope="module")
def spacks(layouts):
    """{S: (reference ShardedTablePack, port ShardedTablePack)}."""
    j, t = layouts
    return {s: (tp_ref.from_sharded_layout(j_packing.shard_pack_layout(j, s)),
                table_pack.from_sharded_layout(packing.shard_pack_layout(t, s),
                                               "cpu"))
            for s in SHARDS}


@pytest.fixture(scope="module")
def port_spacks(layouts, spacks):
    """{S: port ShardedTablePack} for every count of SHARD_COUNTS (no JAX)."""
    return {s: spacks[s][1] if s in spacks else table_pack.from_sharded_layout(
        packing.shard_pack_layout(layouts[1], s), "cpu") for s in SHARD_COUNTS}


def member_inputs(pack, fid, seed=0):
    lo, hi = pack.domains[fid]
    b = pack.boundaries[fid, : pack.n_intervals[fid] + 1].numpy()
    return inputs(lo, hi, b, seed=seed)


# --------------------------------------------------------------------------------------
# layout
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_layout_matches_reference(n_shards, layouts):
    j, t = layouts
    js, ts = j_packing.shard_pack_layout(j, n_shards), packing.shard_pack_layout(t, n_shards)
    assert ts.n_shards == js.n_shards == n_shards
    assert (ts.names, ts.n_intervals, ts.footprint) == (js.names, js.n_intervals,
                                                        js.footprint)
    for a in ("owner", "local_base", "shard_offsets", "shard_sizes"):
        np.testing.assert_array_equal(getattr(ts, a), getattr(js, a), err_msg=a)
    assert ts.max_shard_entries == js.max_shard_entries
    for s in range(n_shards):
        np.testing.assert_array_equal(ts.shard_values(s), js.shard_values(s))
    jp, tp = tp_ref.from_sharded_layout(js), table_pack.from_sharded_layout(ts, "cpu")
    assert (tp.names, tp.n_intervals, tp.n_shards) == (jp.names, jp.n_intervals,
                                                       jp.n_shards)
    for a in ("boundaries", "inv_delta", "seg_count", "local_base", "owned", "values"):
        got, want = getattr(tp, a), np.asarray(getattr(jp, a))
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want, err_msg=a)
    assert tp.footprint_per_shard == jp.footprint_per_shard
    # the owner planes the card's kernels read: the layout's, and the same
    # ownership and rebased bases as the reference's per-shard planes
    np.testing.assert_array_equal(tp.owner.numpy(), js.owner.astype(np.float32))
    np.testing.assert_array_equal(tp.owner_base.numpy(),
                                  js.local_base.astype(np.float32))
    own, lb = np.asarray(jp.owned), np.asarray(jp.local_base)
    for s in range(n_shards):
        mine = js.owner == s
        np.testing.assert_array_equal(own[s], mine.astype(np.float32))
        np.testing.assert_array_equal(lb[s][mine], tp.owner_base.numpy()[mine])
    assert tp.routing_scalars()[0].tolist() == list(jp.routing_scalars()[0])
    assert tp.domains == tuple((float(jp.boundaries[f, 0]),
                                float(jp.boundaries[f, n]))
                               for f, n in enumerate(jp.n_intervals))


def test_layout_errors_match_reference(layouts):
    j, t = layouts
    for bad in (0, -1, t.footprint + 1):
        with pytest.raises(ValueError) as je:
            j_packing.shard_pack_layout(j, bad)
        with pytest.raises(ValueError) as te:
            packing.shard_pack_layout(t, bad)
        assert str(te.value) == str(je.value)
    # a slice at 2^24 entries would no longer address exactly in f32
    big = dataclasses.replace(packing.shard_pack_layout(t, 2),
                              shard_sizes=np.asarray([1 << 24, 1]))
    with pytest.raises(ValueError, match="exact-integer"):
        table_pack.from_sharded_layout(big, "cpu")
    jbig = dataclasses.replace(j_packing.shard_pack_layout(j, 2),
                               shard_sizes=np.asarray([1 << 24, 1]))
    with pytest.raises(ValueError, match="exact-integer"):
        tp_ref.from_sharded_layout(jbig)


def test_silu_is_split_at_four_shards(layouts):
    """The fixture fact the slice relies on: at the default 2 shards every
    member lies in one shard; at 3 shards silu is split, at 4 silu and
    softplus, at 8 five members."""
    _, t = layouts

    def split(s):
        sl = packing.shard_pack_layout(t, s)
        return {n for f, n in enumerate(t.names)
                if len(set(sl.owner[f, : t.n_intervals[f]].tolist())) > 1}

    assert split(2) == set()
    assert split(3) == {"silu"}
    assert split(4) == {"silu", "softplus"}
    assert len(split(8)) == 5
    assert packing.shard_pack_layout(t, 4).shard_sizes.max() == 305
    assert packing.shard_pack_layout(t, 2).shard_sizes.max() == 455


# --------------------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bitwise_reference_and_replicated(n_shards, dtype, spacks, f32):
    jp, tp = spacks[n_shards]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    for fid, name in enumerate(NAMES):
        x = member_inputs(tp, fid, seed=fid)
        xt, xj = torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)
        for ex in (False, True):
            y = table_pack.eval_sharded_ref(tp, name, xt, extrapolate=ex)
            s = table_pack.eval_sharded_slope(tp, name, xt, extrapolate=ex)
            assert y.dtype == s.dtype == tdt and y.shape == xt.shape
            assert_bitwise(_np(y), _jnp(tp_ref.eval_sharded_ref(jp, name, xj,
                                                                extrapolate=ex)))
            assert_bitwise(_np(s), _jnp(tp_ref.eval_sharded_slope(jp, name, xj,
                                                                  extrapolate=ex)))
            _values_equal(_np(y), _np(table_pack.eval_pack_ref(f32, name, xt,
                                                               extrapolate=ex)))
            # at a NaN x the (meaningless) slope reads entry 0: the pack's
            # first entry replicated, the slice's first entry sharded
            keep = ~np.isnan(x)
            _values_equal(_np(s)[keep], _np(table_pack.eval_pack_slope(
                f32, name, xt, extrapolate=ex))[keep])
            # the CPU wrappers are the plain versions, and launch nothing
            _lib.reset_launches()
            assert torch.equal(K.sharded_pack_lookup(tp, name, xt, extrapolate=ex)
                               .view(torch.int16 if dtype == "bfloat16" else torch.int32),
                               y.view(torch.int16 if dtype == "bfloat16" else torch.int32))
            gy, gs = K.sharded_pack_grad(tp, name, xt, extrapolate=ex)
            assert_bitwise(_np(gy), _np(y))
            assert_bitwise(_np(gs), _np(s))
            assert_bitwise(_np(K.sharded_pack_slope(tp, name, xt, extrapolate=ex)),
                           _np(s))
            assert not any(_lib.launches.values())


def test_shard_contributions(spacks):
    """One shard's contribution is the reference's, the owned elements get
    the replicated value, the others exactly 0 (an unowned NaN too)."""
    jp, tp = spacks[4]
    fid = tp.fn_id("silu")
    x = member_inputs(tp, fid, seed=9)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    total, owners = None, 0
    for s in range(tp.n_shards):
        for slope in (False, True):
            c = K.sharded_shard_contrib(tp, "silu", s, xt, extrapolate=True, slope=slope)
            want = tp_ref.shard_contrib_ref(
                jp.values[s], jp.local_base[s, fid], jp.owned[s, fid],
                jp.boundaries[fid], jp.inv_delta[fid], jp.seg_count[fid],
                jp.n_intervals[fid], xj, extrapolate=True, slope=slope)
            assert_bitwise(c.numpy(), np.asarray(want))
            if not slope:
                total = c if total is None else total + c
                owners += bool((c != 0).any())
    assert owners == 2  # silu is split over two of the four shards
    assert_bitwise(total.numpy(), table_pack.eval_sharded_ref(
        tp, "silu", xt, extrapolate=True).numpy())
    nan = torch.tensor([float("nan")])
    owners = [float(K.sharded_shard_contrib(tp, "silu", s, nan)) for s in range(4)]
    assert sum(v == 0.0 for v in owners) == 3 and sum(np.isnan(owners)) == 1
    with pytest.raises(IndexError):
        K.sharded_shard_contrib(tp, "silu", 4, xt)
    for dt in (torch.float64, torch.float16):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            K.sharded_pack_lookup(tp, "silu", torch.zeros(4, dtype=dt))
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            R.sharded_routed_pack_grad(tp, [0], torch.zeros(1, 4, dtype=dt))
    with pytest.raises(KeyError):
        K.sharded_pack_grad(tp, "nope", xt)


def _int_view(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _same_bits(got, want):
    """Bit for bit, NaN positions matched (the sign of a zero counts)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = torch.isnan(got) & torch.isnan(want)
    assert not bool(((_int_view(got) != _int_view(want)) & ~nan).any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_shard_contributions_summed_in_dtype(n_shards, dtype, spacks, port_spacks):
    """The property the card's one-launch sum relies on: the single-shard
    contributions rounded to x's dtype and added in shard order in x's dtype
    (acc = round(acc + c), what one launch over all the shards computes and
    what the S single-shard launches added give) are bit for bit the plain
    ``eval_sharded_ref`` / ``eval_sharded_slope``, which sum in f32 and cast,
    for every member, value and slope, extrapolation off and on, at the edge
    inputs; and at 2 and 4 shards every member's sums are also the
    reference's eager ``eval_sharded_ref`` / ``_slope`` on the same numpy
    inputs (at 1, 3 and 8 shards the reference's layout is held to the
    port's by ``test_layout_matches_reference``).  The routed one-shard
    contributions sum to ``eval_routed_sharded_ref`` the same way.

    Cost, under the tier-1 run's six workers: the inputs are every edge
    input and 512 of the uniform draws (the property is elementwise, and
    tensors this small stay below PyTorch's intra-op parallel grain, whose
    thread regions the other workers slow ~100-fold), and the reference
    runs on the full inputs, whose shapes the test above has compiled, its
    result sliced the same way."""
    tp = port_spacks[n_shards]
    jp = spacks[n_shards][0] if n_shards in spacks else None
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    for fid, name in enumerate(NAMES):
        full = member_inputs(tp, fid, seed=fid)
        x = full[N - 512:]
        xt = torch.from_numpy(x).to(tdt)
        for ex in (False, True):
            for slope, plain, ref in (
                    (False, table_pack.eval_sharded_ref, tp_ref.eval_sharded_ref),
                    (True, table_pack.eval_sharded_slope, tp_ref.eval_sharded_slope)):
                acc = None
                for s in range(n_shards):
                    c = K.sharded_shard_contrib(tp, fid, s, xt, extrapolate=ex,
                                                slope=slope)
                    assert c.dtype == tdt
                    acc = c if acc is None else acc + c
                _same_bits(acc, plain(tp, name, xt, extrapolate=ex))
                if jp is not None:
                    xj = jnp.asarray(full).astype(jdt)
                    assert_bitwise(_np(acc),
                                   _jnp(ref(jp, name, xj, extrapolate=ex))[N - 512:])
    F = len(NAMES)
    ids = [r % F for r in range(2 * F)]
    x = np.stack([np.resize(member_inputs(tp, f, seed=r), 64) for r, f in enumerate(ids)])
    xt = torch.from_numpy(x).to(tdt)
    flags = tuple(f % 2 == 0 for f in range(F))
    acc = None
    for s in range(n_shards):
        c = R.sharded_routed_shard_contrib(tp, ids, s, xt, extrapolate=flags)
        acc = c if acc is None else acc + c
    _same_bits(acc, table_pack.eval_routed_sharded_ref(tp, ids, xt, extrapolate=flags))
    with pytest.raises(IndexError):
        R.sharded_routed_shard_contrib(tp, ids, n_shards, xt)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_staging_image_layout(n_shards, port_spacks):
    """The grads' staging image (``ShardedTablePack.image``) against the
    pack: the header's row starts and sub-interval counts; each member's
    quads (inv_delta, owner-rebased base, seg_count, owner) over its real
    sub-intervals, then its boundaries; the S padded values slices back to
    back; zeros elsewhere; every section on a 16-byte boundary.  stablelm's
    image fits the kernels' 48 KB at every count (1,396 words at 4
    shards)."""
    tp = port_spacks[n_shards]
    S, F, m = tp.n_shards, tp.n_functions, tp.footprint_per_shard
    starts, v_at, words = table_pack.sharded_image_layout(tp.n_intervals, S, m)
    img = tp.image[0]
    assert img.dtype == torch.float32 and img.shape == (words,)
    assert all(w % 4 == 0 for w in starts + (v_at, words)) and starts[0] >= 2 * F
    assert v_at == tp.image[1] and 4 * words <= 48 * 1024
    assert n_shards != 4 or words == 1396
    used = torch.zeros(words, dtype=torch.bool)
    used[: 2 * F] = True
    for f, (at, n) in enumerate(zip(starts, tp.n_intervals)):
        assert (img[2 * f].item(), img[2 * f + 1].item()) == (at, n)
        quads = img[at: at + 4 * n].view(n, 4)
        for k, plane in enumerate((tp.inv_delta, tp.owner_base, tp.seg_count, tp.owner)):
            assert_bitwise(quads[:, k], plane[f, :n])
        assert_bitwise(img[at + 4 * n: at + 5 * n + 1], tp.boundaries[f, : n + 1])
        used[at: at + 5 * n + 1] = True
    assert_bitwise(img[v_at: v_at + S * m], tp.values.reshape(-1))
    used[v_at: v_at + S * m] = True
    assert not bool(img[~used].any())


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_staging_image_covers_every_read(n_shards, port_spacks):
    """A sharded pack rebuilt only from what a grad launch reads of the
    staging image (member f's quads and boundaries from the header's row
    start, the values slices), NaN everywhere else (the other members'
    rows, the padding, a shard's base where it does not own the
    sub-interval), gives each member's plain value and slope with the same
    bits, extrapolation off and on, at NaN (whose extrapolated slope reads
    the owner slice's first pair), +-inf, out-of-domain, boundary and
    subnormal lanes and a point in every cell."""
    tp = port_spacks[n_shards]
    S, m = tp.n_shards, tp.footprint_per_shard
    img, v_at = tp.image
    values = img[v_at: v_at + S * m].view(S, m)
    for f in range(tp.n_functions):
        at, n = int(img[2 * f]), int(img[2 * f + 1])
        quads = img[at: at + 4 * n].view(n, 4)
        bounds = img[at + 4 * n: at + 5 * n + 1]
        planes = {k: torch.full_like(getattr(tp, k), float("nan"))
                  for k in ("boundaries", "inv_delta", "seg_count", "owner",
                            "owner_base", "local_base", "owned")}
        planes["boundaries"][f, : n + 1] = bounds
        for k, name in enumerate(("inv_delta", "owner_base", "seg_count", "owner")):
            planes[name][f, :n] = quads[:, k]
        for s in range(S):
            mine = quads[:, 3] == s
            planes["owned"][s, f, :n] = mine.float()
            planes["local_base"][s, f, :n] = torch.where(mine, quads[:, 1], float("nan"))
        rebuilt = dataclasses.replace(tp, values=values, **planes)
        x = _cell_points(bounds, quads[:, 0], quads[:, 2])
        for ex in (False, True):
            for fn in (table_pack.eval_sharded_ref, table_pack.eval_sharded_slope):
                assert_bitwise(fn(rebuilt, f, x, extrapolate=ex),
                               fn(tp, f, x, extrapolate=ex))


def test_entries_match_argument_builders(spacks):
    """The ctypes rows of the sharded entry points against what the
    argument builders hand them (no launch): every entry takes the
    owner-rebased-base and owner planes, every shard's values slice, the
    shard count and a shard range; the grads' wrappers the range [0, S) and,
    last, the pack's staging image and where its values start (the static
    grad also the member count)."""
    _, tp = spacks[4]
    S, F = tp.n_shards, tp.n_functions
    fid = tp.fn_id("silu")
    x = torch.zeros(3, 5)
    routed = R._sharded_routed_args(tp, [0, 1, 5], x, True, 1, 3)
    cases = {
        "tp_spack_lookup": K._sharded_args(tp, fid, 0, S, 1, 0),
        "tp_spack_grad": K._sharded_grad_args(tp, fid, True),
        "tp_sharded_routed_lookup": routed,
        "tp_sharded_routed_grad": R._sharded_routed_grad_args(tp, [0, 1, 5], x, True),
    }
    for entry, (planes, ints) in cases.items():
        _, n_planes, n_int = _lib._ENTRIES[entry]
        assert (len(planes), len(ints)) == (n_planes, n_int), entry
        assert all(p.is_contiguous() and p.dtype in (torch.float32, torch.int32)
                   for p in planes), entry
        assert all(isinstance(i, int) for i in ints), entry
        grad = int(entry.endswith("grad"))
        assert (planes[-4 - grad] is tp.owner_base and planes[-2 - grad] is tp.owner
                and planes[-1 - grad] is tp.values), entry
        assert not grad or planes[-1] is tp.image[0], entry
    v_at = table_pack.sharded_image_layout(tp.n_intervals, S, tp.footprint_per_shard)[1]
    planes, ints = cases["tp_spack_lookup"]
    assert ints == (fid, tp.n_max, tp.n_intervals[fid], tp.footprint_per_shard,
                    S, 0, S, 1, 0)
    assert cases["tp_spack_grad"][1] == (fid, tp.n_max, tp.n_intervals[fid],
                                         tp.footprint_per_shard, S, 0, S, 1, F, v_at)
    rplanes, rints = routed
    assert rplanes[0].tolist() == [0, 1, 5] and rplanes[0].dtype == torch.int32
    assert rints == (F, tp.n_max, tp.footprint_per_shard, S, 1, 3, 3)
    assert cases["tp_sharded_routed_grad"][1] == (F, tp.n_max, tp.footprint_per_shard,
                                                  S, 0, S, 3, v_at)
    # the one-shard contribution is the value entry over a range of one
    assert K._sharded_args(tp, fid, 3, 4, 0, 1)[1][4:] == (S, 3, 4, 0, 1)
    with pytest.raises(ValueError, match="takes 6 planes and 9 int"):
        _lib.launch("tp_spack_lookup", x, planes[3:], ints)
    # the folded, TableFlash, every static and every routed entry (but the
    # sharded ones) take their pack's (or table's) staging image
    fp = table_pack.build_pack(("silu", "sin_core", "cos_core", "exp_core", "log_core",
                                "exp_neg"), EA, omega=OMEGA, device="cpu")
    qp = table_pack.build_quant_pack(("silu", "tanh"), EA, omega=OMEGA, device="cpu")
    pp = table_pack.from_poly_layout(packing.poly_pack_layout(
        [design.poly_member(n, EA, degree=d, bits=b)
         for n, d, b in (("tanh", 1, 32), ("exp_neg", 3, 8), ("gelu", 2, 16))]), "cpu")
    jt = ApproxConfig(e_a=EA, omega=OMEGA).table_for("silu", "cpu")
    cases = {f"tp_folded_{e} {name}": (K._folded_args(fp, name), fp.fold_images[name])
             for e in ("lookup", "grad") for name in ("sin", "cos", "exp", "log")}
    cases["tp_tableflash_exp"] = (K._flash_args(fp), fp.flash_image)
    for e in ("lookup", "grad"):
        cases[f"tp_routed_poly_{e}"] = (R._routed_poly_args(pp, [0, 2, 1], x, True),
                                        (pp.image, pp.inv_delta.shape[0]))
        cases[f"tp_routed_quant_{e}"] = (R._routed_quant_args(qp, [0, 1, 1], x, True),
                                         (qp.image, qp.inv_delta.shape[0]))
        cases[f"tp_poly_{e}"] = (K._poly_args(pp, 2, True),
                                 (pp.image, pp.inv_delta.shape[0]))
        cases[f"tp_routed_{e}"] = (R._routed_args(fp, [0, 1, 5], x, True), fp.image)
        cases[f"tp_pack_{e}"] = (K._pack_image_args(fp, 5, True), fp.image)
        cases[f"tp_quant_{e}"] = (K._quant_args(qp, 1, True),
                                  (qp.image, qp.inv_delta.shape[0]))
        cases[f"tp_table_{e}"] = ((TL.table_planes(jt), (jt.n_intervals, jt.footprint, 1)),
                                  (jt.image, jt.footprint))
    for key, ((planes, ints), (image, count)) in cases.items():
        _, n_planes, n_int = _lib._ENTRIES[key.split()[0]]
        assert (len(planes), len(ints)) == (n_planes, n_int), key
        assert all(p.is_contiguous() and p.dtype in (torch.float32, torch.int32,
                                                     torch.int16, torch.int8)
                   for p in planes), key
        assert all(isinstance(i, int) for i in ints), key
        assert planes[-1] is image, key
        # the count that places the image's values (the static poly and
        # quant entries: the sub-intervals, then the code groups' sizes; a
        # table's: its values, before the flag)
        family = key.split()[0].rsplit("_", 1)[0]
        at = {"tp_poly": -4, "tp_quant": -3, "tp_table": -2}.get(
            family, -2 if "routed" in key else -1)
        assert ints[at] == count, key
    (planes, ints), _ = cases["tp_routed_lookup"]
    assert planes[2] is fp.image_rows and ints[3] == sum(fp.n_intervals)
    (planes, ints), _ = cases["tp_poly_lookup"]
    assert ints[8:] == (pp.n_functions, pp.inv_delta.shape[0], pp.codes8.shape[0],
                        pp.codes16.shape[0], pp.codes32.shape[0])
    starts, v_at = table_pack.member_image_layout(fp.n_intervals)
    assert cases["tp_pack_lookup"][0][1] == K._pack_args(fp, 5, 1)[1] + (starts[5], v_at,
                                                                         fp.image[1])
    assert cases["tp_quant_lookup"][0][1][6:] == (qp.n_functions, qp.inv_delta.shape[0],
                                                  qp.codes8.shape[0], qp.codes16.shape[0])
    assert fp.fold_images["sin"] is fp.fold_images["cos"]
    assert K._flash_args(fp)[1][:4] == K._pack_args(fp, fp.fn_id("exp_neg"))[1]
    assert K._folded_args(fp, "exp")[1][:2] == (fp.fn_id("exp_core"),) * 2


@pytest.mark.parametrize("n_shards", SHARDS)
def test_plain_within_ulp_of_interpret_kernels(n_shards, spacks, f32):
    """The reference's sharded kernels in interpret mode, one member a shard
    count (the one split at 4 shards), a few hundred elements."""
    jp, tp = spacks[n_shards]
    name = "silu" if n_shards == 4 else "exp_neg"
    fid = tp.fn_id(name)
    ex = name == "silu"
    x = member_inputs(tp, fid, seed=3)
    x = x[np.isfinite(x)][:320].reshape(2, 160)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    y = table_pack.eval_sharded_ref(tp, name, xt, extrapolate=ex)
    s = table_pack.eval_sharded_slope(tp, name, xt, extrapolate=ex)
    scale = lerp_scale(f32.boundaries[fid], f32.inv_delta[fid], f32.base[fid],
                       f32.seg_count[fid], f32.n_intervals[fid], f32.values,
                       x.reshape(-1), ex).reshape(x.shape)
    assert_within_ulp(y.numpy(), np.asarray(sharded_pack_lookup_pallas(
        jp, name, xj, extrapolate=ex)), scale)
    assert_within_ulp(s.numpy(), np.asarray(sharded_pack_slope_pallas(
        jp, name, xj, extrapolate=ex)), s.numpy())
    gy, gs = sharded_pack_grad_pallas(jp, name, xj, extrapolate=ex)
    assert_within_ulp(y.numpy(), np.asarray(gy), scale)
    assert_within_ulp(s.numpy(), np.asarray(gs), s.numpy())
    # one shard's contribution through the mesh-local entry
    c = sharded_shard_contrib_pallas(
        jp.boundaries, jp.inv_delta, jp.seg_count, jp.local_base[0], jp.owned[0],
        jp.values[0], xj, fn_id=fid, n_intervals=jp.n_intervals[fid], extrapolate=ex)
    assert_within_ulp(K.sharded_shard_contrib(tp, fid, 0, xt, extrapolate=ex).numpy(),
                      np.asarray(c), scale)
    # the routed kernels: one row per member, the rows' own extrapolate flags
    flags = tuple(n in ("gelu", "silu", "softplus") for n in NAMES)
    xr = np.stack([member_inputs(tp, f, seed=4)[:200] for f in range(len(NAMES))])
    xr = np.where(np.isfinite(xr), xr, 0.0).astype(np.float32)
    ids = list(range(len(NAMES)))
    ry = table_pack.eval_routed_sharded_ref(tp, ids, torch.from_numpy(xr),
                                            extrapolate=flags)
    rs = table_pack.eval_routed_sharded_slope(tp, ids, torch.from_numpy(xr),
                                              extrapolate=flags)
    rscale = np.stack([lerp_scale(
        f32.boundaries[f], f32.inv_delta[f], f32.base[f], f32.seg_count[f],
        f32.n_intervals[f], f32.values, xr[f], flags[f]) for f in ids])
    jy = sharded_routed_pack_lookup_pallas(jp, jnp.asarray(ids, jnp.int32),
                                           jnp.asarray(xr), extrapolate=flags)
    assert_within_ulp(ry.numpy(), np.asarray(jy), rscale)
    jy, js = sharded_routed_pack_grad_pallas(jp, jnp.asarray(ids, jnp.int32),
                                             jnp.asarray(xr), extrapolate=flags)
    assert_within_ulp(ry.numpy(), np.asarray(jy), rscale)
    assert_within_ulp(rs.numpy(), np.asarray(js), rs.numpy())


# --------------------------------------------------------------------------------------
# routed oracles
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["off", "on", "per member"])
def test_routed_oracles_match_reference_and_replicated(which, spacks, f32):
    jp, tp = spacks[4]
    F = len(NAMES)
    ex = (tuple(f % 2 == 0 for f in range(F)) if which == "per member"
          else which == "on")
    ids = [r % F for r in range(2 * F)]
    cols = 400
    x = np.stack([np.resize(member_inputs(tp, f, seed=r), cols)
                  for r, f in enumerate(ids)])
    x = np.where(np.isfinite(x), x, 0.0).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        xj = jnp.asarray(x).astype(getattr(jnp, dtype))
        y = table_pack.eval_routed_sharded_ref(tp, ids, xt, extrapolate=ex)
        s = table_pack.eval_routed_sharded_slope(tp, ids, xt, extrapolate=ex)
        assert_bitwise(_np(y), _jnp(tp_ref.eval_routed_sharded_ref(
            jp, ids, xj, extrapolate=ex)))
        assert_bitwise(_np(s), _jnp(tp_ref.eval_routed_sharded_slope(
            jp, ids, xj, extrapolate=ex)))
        _values_equal(_np(y), _np(table_pack.eval_routed_ref(f32, ids, xt,
                                                             extrapolate=ex)))
        _values_equal(_np(s), _np(table_pack.eval_routed_slope(f32, ids, xt,
                                                               extrapolate=ex)))
        # the CPU wrappers; a torch id tensor is clamped to [0, F-1]
        _lib.reset_launches()
        assert_bitwise(_np(R.sharded_routed_pack_lookup(tp, ids, xt, extrapolate=ex)),
                       _np(y))
        gy, gs = R.sharded_routed_pack_grad(tp, ids, xt, extrapolate=ex)
        assert_bitwise(_np(gy), _np(y))
        assert_bitwise(_np(gs), _np(s))
        dev_ids = torch.tensor([-3, 10_000] + ids[2:])
        clamped = [0, F - 1] + ids[2:]
        assert_bitwise(_np(R.sharded_routed_pack_lookup(tp, dev_ids, xt, extrapolate=ex)),
                       _np(table_pack.eval_routed_sharded_ref(tp, clamped, xt,
                                                              extrapolate=ex)))
        assert not any(_lib.launches.values())


# --------------------------------------------------------------------------------------
# closures, gradients and modes
# --------------------------------------------------------------------------------------


def _grad(f, x, dy):
    x = x.clone().requires_grad_(True)
    y = f(x)
    y.backward(dy)
    return y.detach(), x.grad


@pytest.mark.parametrize("use_kernel", [True, False])
def test_closures_value_and_gradient(use_kernel, spacks):
    jp, tp = spacks[4]
    rng = np.random.default_rng(21)
    for fid, name in enumerate(NAMES):
        x = member_inputs(tp, fid, seed=fid)
        x = np.where(np.isfinite(x), x, 0.0).astype(np.float32)
        dy = rng.normal(0, 1, x.shape).astype(np.float32)
        xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
        ex = name in ("gelu", "silu", "softplus")
        f = table_pack.make_sharded_pack_fn(tp, name, use_kernel=use_kernel,
                                            extrapolate=ex)
        y, g = _grad(f, xt, dyt)
        assert torch.equal(f(xt), y)  # the value path without a gradient
        assert torch.equal(g, table_pack.eval_sharded_slope(tp, name, xt,
                                                            extrapolate=ex) * dyt)
        jy, vjp = jax.vjp(tp_ref.make_sharded_pack_fn(jp, name, use_pallas=False,
                                                      extrapolate=ex), jnp.asarray(x))
        assert_bitwise(y.numpy(), jy)
        assert_bitwise(g.numpy(), vjp(jnp.asarray(dy))[0])
        d1 = lambda v: torch.cos(v)  # exact_d1 is honoured
        _, g = _grad(table_pack.make_sharded_pack_fn(
            tp, name, use_kernel=use_kernel, exact_d1=d1, extrapolate=ex), xt, dyt)
        assert torch.equal(g, torch.cos(xt) * dyt)
    # routed over the sharded pack, with its gradient, and the routed unary
    ids = list(range(len(NAMES)))
    x = np.stack([np.resize(member_inputs(tp, f, seed=7), 96) for f in ids])
    x = np.where(np.isfinite(x), x, 0.0).astype(np.float32)
    dy = rng.normal(0, 1, x.shape).astype(np.float32)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    y, g = _grad(table_pack.make_routed_fn(tp, ids, use_kernel=use_kernel,
                                           extrapolate=True), xt, dyt)
    jy, vjp = jax.vjp(tp_ref.make_routed_fn(jp, ids, use_pallas=False, extrapolate=True),
                      jnp.asarray(x))
    assert_bitwise(y.numpy(), jy)
    assert_bitwise(g.numpy(), vjp(jnp.asarray(dy))[0])
    y, g = _grad(table_pack.make_routed_unary_fn(tp, "silu", use_kernel=use_kernel,
                                                 extrapolate=True), xt, dyt)
    assert torch.equal(y, table_pack.eval_sharded_ref(tp, "silu", xt, extrapolate=True))
    assert torch.equal(g, table_pack.eval_sharded_slope(tp, "silu", xt,
                                                        extrapolate=True) * dyt)


@pytest.mark.parametrize("mode", SHARDED_MODES)
def test_approx_config_matches_reference(mode):
    """unary (remaps and odd mirroring included), exact_grad, routed_fn with
    mirrored tanh rows, against the reference's plain mode; TableFlash and
    the rotary trig stay on the f32 pack."""
    from repro.approx.activations import TABLE_MODES as J_TABLE_MODES

    assert TABLE_MODES == J_TABLE_MODES  # every mode of the reference is ported
    a = ApproxConfig(mode=mode, e_a=EA, omega=OMEGA, pack_shards=4)
    j = JApprox(mode="sharded_pack_ref", e_a=EA, omega=OMEGA, pack_shards=4)
    sp = a.sharded_pack("cpu")
    assert a._pack_for_mode("cpu") is sp and sp.n_shards == 4
    assert a.sharded_pack("cpu") is sp  # cached per config and device
    assert dataclasses.replace(a, pack_shards=3).sharded_pack("cpu").n_shards == 3
    rng = np.random.default_rng(31)
    x = rng.normal(0, 4, (3, 64)).astype(np.float32)
    dy = rng.normal(0, 1, x.shape).astype(np.float32)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    for name in ("silu", "gelu", "tanh", "sigmoid", "exp", "softplus"):
        y, g = _grad(a.unary(name, "cpu"), xt, dyt)
        jy, vjp = jax.vjp(j.unary(name), jnp.asarray(x))
        assert_bitwise(y.numpy(), jy)
        assert_bitwise(g.numpy(), vjp(jnp.asarray(dy))[0])
    ea = dataclasses.replace(a, exact_grad=True)
    _, g = _grad(ea.unary("gelu", "cpu"), torch.zeros(8), torch.ones(8))
    np.testing.assert_allclose(g.numpy(), 0.5, atol=1e-6)  # gelu'(0), not a table slope
    fns = ("tanh", "silu", "sigmoid")
    y, g = _grad(a.routed_fn(fns, "cpu"), xt, dyt)
    jy, vjp = jax.vjp(j.routed_fn(fns), jnp.asarray(x))
    assert_bitwise(y.numpy(), jy)
    assert_bitwise(g.numpy(), vjp(jnp.asarray(dy))[0])
    # TableFlash and the rotary sin/cos are served from the f32 pack
    fa = dataclasses.replace(a, attn_table=True, rope_table=True)
    z = torch.from_numpy(-np.abs(x) * 4)
    want = table_pack.make_attn_exp_fn(fa.pack("cpu"), use_kernel=False)(z)
    assert torch.equal(fa.attn_exp("cpu")(z), want)
    assert_bitwise(want.numpy(), tp_ref.make_attn_exp_fn(
        JApprox(mode="table_pack_ref", e_a=EA, omega=OMEGA).pack(),
        use_pallas=False)(jnp.asarray(z.numpy())))
    s, c = fa.rope_sin_cos("cpu")(xt.abs() * 10)
    assert float((s - torch.sin(xt.abs() * 10)).abs().max()) < 1e-3
    assert float((c - torch.cos(xt.abs() * 10)).abs().max()) < 1e-3


# --------------------------------------------------------------------------------------
# the model and the launchers
# --------------------------------------------------------------------------------------


def _pair(mode, shards=4):
    from repro.models import build_model as j_build_model
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_model, reduced
    from tests.test_archs import reduced as j_reduced

    jm = j_build_model(j_reduced("stablelm-3b").replace(
        compute_dtype="float32", approx=JApprox(
            mode=mode, e_a=EA, omega=OMEGA, attn_table=True, pack_shards=shards)))
    tm = build_model(reduced("stablelm-3b").replace(
        compute_dtype="float32", approx=ApproxConfig(
            mode=mode, e_a=EA, omega=OMEGA, attn_table=True, pack_shards=shards)),
        device="cpu")
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_jax(tm.cfg, jax.tree.map(np.asarray, jp), "cpu")


def test_model_serves_and_trains_as_replicated_and_reference():
    from repro.serving.engine import ContinuousEngine as JContinuousEngine
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ContinuousEngine
    from repro_torch.train.loop import accumulated_grads, batch_to
    from repro_torch.tree import leaves
    from tests.test_serving import mixed_requests
    from tests.test_torch_train import assert_grads_close, np_batch, rel

    jm, jp, tm, tp = _pair("sharded_pack_ref")
    rm = build_model(tm.cfg.replace(approx=dataclasses.replace(
        tm.cfg.approx, mode="table_pack_ref")), device="cpu")
    V = tm.cfg.vocab
    toks = np.random.default_rng(0).integers(0, V, (2, 9)).astype(np.int32)
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                            tm.init_cache(2, 16))
        rl, rc = rm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                            rm.init_cache(2, 16))
        jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(2, 16))
        tok = torch.argmax(tl, -1)[:, None]
        pos = torch.tensor([9, 9], dtype=torch.int32)
        td, _ = tm.decode_step(tp, tok, pos, tc)
        rd, _ = rm.decode_step(tp, tok, pos, rc)
        jd, _ = jax.jit(jm.decode_step)(jp, jnp.asarray(tok.numpy().astype(np.int32)),
                                        jnp.asarray(pos.numpy()), jc)
    for got, rep, want in ((tl, rl, jl), (td, rd, jd)):
        assert torch.equal(got, rep)
        assert np.abs(got.numpy()[:, :V] - np.asarray(want)[:, :V]).max() <= 1e-4
    reqs = lambda: mixed_requests(np.random.default_rng(3), 6)
    want = JContinuousEngine(jm, jp, batch_size=2, cache_len=64).serve(reqs())
    got = ContinuousEngine(tm, tp, batch_size=2, cache_len=64).serve(reqs())
    rep = ContinuousEngine(rm, tp, batch_size=2, cache_len=64).serve(reqs())
    for i, (a, b, c) in enumerate(zip(want, got, rep)):
        np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=f"req {i}")
        np.testing.assert_array_equal(b.tokens, c.tokens, err_msg=f"req {i}")
    # step 0: loss and grads (accum 2) equal to table_pack_ref's, and the
    # reference's within the training bounds
    b = np_batch(V, seed=5)
    l, g = accumulated_grads(tm, tp, batch_to(b, "cpu"), 2)
    lr_, gr = accumulated_grads(rm, tp, batch_to(b, "cpu"), 2)
    assert torch.equal(l, lr_)
    for a, c in zip(leaves(g), leaves(gr)):
        assert torch.equal(a, c)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    assert rel(l, jl) <= 1e-5
    assert_grads_close(tm.cfg, jg, g)


@pytest.mark.parametrize("mode", SHARDED_MODES)
def test_serve_cli_pack_shards(mode, capsys, monkeypatch):
    from repro_torch.launch import serve

    seen = []
    build = serve.build_model
    monkeypatch.setattr(serve, "build_model",
                        lambda cfg, device: seen.append(cfg) or build(cfg, device))
    res = serve.main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                      "--requests", "3", "--batch", "2", "--max-new", "3",
                      "--approx-mode", mode, "--pack-shards", "4", "--attn-table"])
    assert [r.steps for r in res] == [3, 3, 3]
    assert "served 3 requests, 9 tokens on cpu" in capsys.readouterr().out
    assert (seen[0].approx.mode, seen[0].approx.pack_shards) == (mode, 4)
    # only what was passed is overridden
    serve.main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                "--requests", "1", "--batch", "1", "--max-new", "1",
                "--pack-shards", "3"])
    from repro_torch.models import reduced
    assert seen[1].approx == dataclasses.replace(reduced("stablelm-3b").approx,
                                                 pack_shards=3)


def test_train_cli_pack_shards(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import train

    seen = []
    build = train.build_model
    monkeypatch.setattr(train, "build_model",
                        lambda cfg, device: seen.append(cfg) or build(cfg, device))
    out = train.main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "4", "--seq", "16", "--accum", "2",
                      "--approx-mode", "sharded_pack", "--pack-shards", "4",
                      "--ckpt-dir", str(tmp_path)])
    assert "done: step=2 loss" in capsys.readouterr().out
    assert all(np.isfinite(out["losses"]))
    assert (seen[0].approx.mode, seen[0].approx.pack_shards) == ("sharded_pack", 4)
