"""The paper's own layer in the port, held to the reference on the CPU: the
BRAM18 counts, the t-tests, the fixed-point formats, the mixed-width quantized
tables, ``run_flow``, TableFlash's error bound, the paper's figures and
tables (``launch/paper.py`` against ``benchmarks/paper_figs.py``) and the
torch quickstart.

Both packages run the same f64 numpy on the same inputs, so every comparison
is exact (``==`` / ``assert_array_equal``) unless a test says otherwise; the
error bounds (``<= Ea``, ``flash_abs_bound``) are the reference's own.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jc
from benchmarks import paper_figs as jp
from repro.configs import tabla_paper as j_cells
from repro.core import attn_error as j_attn
from repro.core import stats as j_stats
from repro.core.packing import quantize_table as j_quantize_table
from repro_torch import core as tc
from repro_torch.approx import ApproxConfig, from_spec
from repro_torch.configs import tabla_paper as t_cells
from repro_torch.core import attn_error as t_attn
from repro_torch.core import bram as t_bram
from repro_torch.core import stats as t_stats
from repro_torch.core.packing import quantize_table as t_quantize_table
from repro_torch.launch import paper as tp
from repro_torch.models import get_config
from repro_torch.models.attention import flash_attention
from tests.test_table_flash import EA, EA_EFF, GEOMETRIES, KV_CHUNK

ROOT = Path(__file__).resolve().parent.parent
TABLE_FIELDS = ("boundaries", "inv_delta", "delta", "base", "seg_count", "values")


# --------------------------------------------------------------------------------------
# Exports and cells
# --------------------------------------------------------------------------------------


def test_core_exports_the_references_names():
    """The reference's ``repro.core.__all__``, with the kernels' staging
    reports (``SmemCost``, ``smem_cost``; ``SmemPackCost``, ``smem_cost_pack``
    for a pack) in place of the TPU VMEM ones."""
    want = set(jc.__all__) - {"vmem_cost", "vmem_cost_pack"} | {
        "SmemCost", "smem_cost", "SmemPackCost", "smem_cost_pack"}
    assert set(tc.__all__) == want
    for name in tc.__all__:
        assert getattr(tc, name) is not None, name


def test_paper_cells_equal_and_not_an_arch():
    for k in ("E_A_TABLE2", "E_A_FIG3", "E_A_WORKED", "TABLE2_CELLS", "TABLE3_CELLS",
              "OMEGA_SWEEP"):
        assert getattr(t_cells, k) == getattr(j_cells, k), k
    assert t_cells.FORMATS is tc.PAPER_FORMATS
    assert not hasattr(t_cells, "CONFIG")
    with pytest.raises(NotImplementedError):
        get_config("tabla-paper")


# --------------------------------------------------------------------------------------
# BRAM18 counts and the staging image
# --------------------------------------------------------------------------------------


BRAM_CASES = [(15_644, 32), (8_798, 32), (1024, 32), (1025, 32), (81_543, 32),
              (16_384, 1), (8_192, 2), (1_024, 18), (513, 36), (770, 9), (100, 40)]


def test_bram_counts_equal():
    """The cases of tests/test_core_paper.py's TestResourceModels, and seeded
    footprints at every width 1..72."""
    for fp, w in BRAM_CASES:
        assert tc.bram_count(fp, w) == jc.bram_count(fp, w), (fp, w)
        assert tc.bram_count_packed(fp, w) == jc.bram_count_packed(fp, w), (fp, w)
    assert [tc.bram_count(fp) for fp in (15_644, 8_798, 1024, 1025, 81_543)] == \
        [16, 16, 1, 2, 128]
    rng = np.random.default_rng(0)
    for fp in rng.integers(1, 200_000, 40):
        for w in range(1, 73):
            assert tc.bram_count_packed(int(fp), w) == jc.bram_count_packed(int(fp), w)
        assert tc.bram_count(int(fp)) == jc.bram_count(int(fp))
    assert t_bram.BRAM18_DEPTH == jc.bram.BRAM18_DEPTH
    assert t_bram.PAPER_DEPTH_32BIT == jc.bram.PAPER_DEPTH_32BIT
    with pytest.raises(ValueError):
        tc.bram_count(0)


@pytest.mark.parametrize("name,e_a,lo,hi,omega", [
    ("log", 1.22e-4, 0.625, 15.625, 0.3), ("tanh", 9.5367e-7, -8.0, 8.0, 0.1),
    ("exp", 9.5367e-7, 0.0, 5.0, 0.3), ("gelu", 1e-4, None, None, 0.2)])
def test_smem_cost_is_the_tables_staging_image(name, e_a, lo, hi, omega):
    """``smem_cost`` is ``4 * TorchTable.image.numel()`` (exact), on both sides of
    the 48 KB budget (exp [0, 5) at the paper's Ea is past it)."""
    spec = tc.build_table(name, e_a, lo, hi, "hierarchical", omega)
    sm = tc.smem_cost(spec.footprint, spec.n_intervals)
    jt = from_spec(spec, "cpu")
    assert sm.image_bytes == 4 * jt.image.numel()
    assert sm.table_bytes == 4 * spec.footprint
    assert sm.fits == (4 * jt.image.numel() <= 48 * 1024)
    assert sm.fits == (name != "exp")


# --------------------------------------------------------------------------------------
# t-tests
# --------------------------------------------------------------------------------------


def test_t_cdf_and_betainc_equal():
    for df in (1, 2, 5, 18, 58, 198):
        for t in (-8.0, -2.1, -0.3, 0.0, 0.7, 1.9, 4.4, 30.0):
            assert t_stats.t_cdf(t, df) == j_stats.t_cdf(t, df), (t, df)
    for a, b, x in ((0.5, 0.5, 0.3), (9.0, 0.5, 0.97), (2.0, 3.0, 0.0), (2.0, 3.0, 1.0)):
        assert t_stats.betainc_reg(a, b, x) == j_stats.betainc_reg(a, b, x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ttest2_and_outperforms_equal(seed):
    rng = np.random.default_rng(seed)
    n1, n2 = rng.integers(3, 30, 2)
    g1 = rng.normal(0.0, 1.0, n1)
    g2 = rng.normal(0.4 * seed, 1.0 + seed, n2)
    groups = [(g1, g2), (g2, g1), (g1, g1.copy()), (np.ones(4), np.ones(5) * 2)]
    for a, b in groups:
        assert dataclasses.asdict(t_stats.ttest2(a, b)) == \
            dataclasses.asdict(j_stats.ttest2(a, b))
        for alpha in (0.01, 0.05, 0.2):
            assert tc.outperforms(a, b, alpha) == jc.outperforms(a, b, alpha)
        r = tc.ttest2(a, b)
        for tail in ("two", "right", "left"):
            assert r.reject(tail) == j_stats.ttest2(a, b).reject(tail)
    with pytest.raises(ValueError):
        tc.ttest2([1.0], [1.0, 2.0])


# --------------------------------------------------------------------------------------
# Fixed-point formats and mixed-width quantized tables
# --------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jc.PAPER_FORMATS))
def test_fixed_point_formats_bitwise(name):
    assert tuple(map(dataclasses.astuple, tc.PAPER_FORMATS[name])) == \
        tuple(map(dataclasses.astuple, jc.PAPER_FORMATS[name]))
    x = np.random.default_rng(3).normal(0.0, 4.0, 4096)
    x[:6] = [0.0, -0.0, 1e9, -1e9, 0.5, -0.5]
    for t_fmt, j_fmt in zip(tc.PAPER_FORMATS[name], jc.PAPER_FORMATS[name]):
        assert t_fmt.resolution == j_fmt.resolution
        assert (t_fmt.min_value, t_fmt.max_value, t_fmt.scale) == \
            (j_fmt.min_value, j_fmt.max_value, j_fmt.scale)
        np.testing.assert_array_equal(t_fmt.quantize(x).view(np.int64),
                                      j_fmt.quantize(x).view(np.int64))
        codes = t_fmt.to_bits(x)
        np.testing.assert_array_equal(codes, j_fmt.to_bits(x))
        np.testing.assert_array_equal(t_fmt.from_bits(codes), j_fmt.from_bits(codes))
    with pytest.raises(ValueError):
        tc.FixedPointFormat(1, 32, 32)


@pytest.mark.parametrize("name,e_a,lo,hi,menu", [
    ("log", 1e-4, 0.625, 15.625, "PACKED_WIDTHS"),
    ("tanh", 1e-4, -8.0, 8.0, "BRAM_WIDTHS"),
    ("silu", 1e-4, -10.0, 10.0, "INT_WIDTHS")])
def test_quantize_table_equal(name, e_a, lo, hi, menu):
    from repro.core import packing as jpk
    from repro_torch.core import packing as tpk

    assert getattr(tpk, menu) == getattr(jpk, menu)
    got = t_quantize_table(name, e_a, lo, hi, omega=0.1, width_menu=getattr(tpk, menu))
    want = j_quantize_table(name, e_a, lo, hi, omega=0.1, width_menu=getattr(jpk, menu))
    for f in ("q_values", "scale", "zero", "bits"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(got.base, f), getattr(want.base, f))
    assert (got.footprint_bits, got.footprint_bits_fp32, got.bit_reduction) == \
        (want.footprint_bits, want.footprint_bits_fp32, want.bit_reduction)
    err = got.max_error_on_grid(n=20_001)
    assert err == want.max_error_on_grid(n=20_001)
    assert err <= e_a


# --------------------------------------------------------------------------------------
# run_flow
# --------------------------------------------------------------------------------------


FLOW_CELLS = {
    "fig3": ("log", 1.25e-4, 0.625, 15.625, "reference", 0.3, {}),
    "fig45 reference": ("log", 1.22e-4, 0.625, 15.625, "reference", 0.3, {}),
    "fig45 binary": ("log", 1.22e-4, 0.625, 15.625, "binary", 0.3, {}),
    "fig45 hierarchical": ("log", 1.22e-4, 0.625, 15.625, "hierarchical", 0.3,
                           {"epsilon": 0.015}),
    "fig45 sequential": ("log", 1.22e-4, 0.625, 15.625, "sequential", 0.3,
                         {"epsilon": 0.3}),
    "table2 tan": ("tan", 9.5367e-7, -1.5, 0.0, "hierarchical", 0.3, {}),
    "table2 sigmoid": ("sigmoid", 9.5367e-7, -10.0, 0.0, "hierarchical", 0.3, {}),
}


@pytest.mark.parametrize("cell", sorted(FLOW_CELLS))
def test_run_flow_equal(cell):
    """Every field of the reference's FlowReport but its VMEM cost, and the
    spec's arrays bitwise; the port's ``smem`` is the table's image bytes."""
    name, e_a, lo, hi, alg, omega, kw = FLOW_CELLS[cell]
    got = tc.run_flow(name, e_a, lo, hi, alg, omega, verify_error=True, **kw)
    want = jc.run_flow(name, e_a, lo, hi, alg, omega, verify_error=True, **kw)
    for f in ("reference_footprint", "footprint", "reduction_pct", "n_intervals",
              "brams", "brams_reference", "measured_max_error"):
        assert getattr(got, f) == getattr(want, f), f
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(got.spec, f), getattr(want.spec, f))
    assert (got.spec.name, got.spec.lo, got.spec.hi, got.spec.e_a,
            got.spec.algorithm) == (want.spec.name, want.spec.lo, want.spec.hi,
                                    want.spec.e_a, want.spec.algorithm)
    assert got.measured_max_error <= e_a
    assert got.smem == tc.smem_cost(got.footprint, got.n_intervals)
    assert got.smem.image_bytes == 4 * from_spec(got.spec, "cpu").image.numel()
    head = want.summary().split(", VMEM")[0]
    assert got.summary().startswith(head + ", SMEM")


# --------------------------------------------------------------------------------------
# TableFlash's error bound
# --------------------------------------------------------------------------------------


def test_attn_error_functions_equal():
    assert t_attn.EXP_NEG_LO == j_attn.EXP_NEG_LO
    assert tc.get_function("exp_neg").interval[0] == t_attn.EXP_NEG_LO
    for e_a in (1e-6, 1e-4, 3e-3):
        assert t_attn.lookup_delta(e_a) == j_attn.lookup_delta(e_a)
        d = t_attn.lookup_delta(e_a)
        for c in (1, 2, 7, 64):
            assert t_attn.weight_error(c, d) == j_attn.weight_error(c, d)
        for n_keys, chunk, vmax in ((24, 8, 1.3), (256, 1024, 4.0), (2048, 1024, 2.5),
                                    (1 << 20, 1, 1.0)):
            assert t_attn.flash_abs_bound(e_a, n_keys, chunk, vmax) == \
                j_attn.flash_abs_bound(e_a, n_keys, chunk, vmax)
    assert t_attn.weight_error(10**6, 0.5) == j_attn.weight_error(10**6, 0.5) == math.inf
    with pytest.raises(ValueError):
        t_attn.flash_abs_bound(1e-4, 0, 8, 1.0)


B, SQ, T, G, QG, D = 2, 6, 24, 2, 2, 8  # the reference test's shapes


def _flash_inputs(geom, seed=0):
    """tests/test_table_flash.py's ``_inputs``, as torch tensors."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(0, 1, (B, SQ, G, QG, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 1, (B, T, G, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (B, T, G, D)).astype(np.float32))
    if geom["clocks"]:
        q_pos = torch.tensor([[T - SQ + i for i in range(SQ)],
                              [T - SQ + 3 + i for i in range(SQ)]], dtype=torch.int32)
        k_pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
        if geom["empty"]:
            k_pos[:, T - 2:] = -1
        k_pos = torch.from_numpy(k_pos)
    else:
        q_pos = torch.arange(T - SQ, T, dtype=torch.int32)
        k_pos = torch.arange(T, dtype=torch.int32)
    return q, k, v, q_pos, k_pos


@pytest.mark.parametrize("geom_name", sorted(GEOMETRIES))
def test_table_flash_within_bound(geom_name):
    """The port's flash_attention with the plain exp_neg lookup (table_pack on
    the CPU) against exp_fn=None, within ``flash_abs_bound`` at the
    reference's geometries, EA and EA_EFF."""
    geom = GEOMETRIES[geom_name]
    q, k, v, q_pos, k_pos = _flash_inputs(geom)
    fn = ApproxConfig(mode="table_pack", e_a=EA, omega=0.2,
                      attn_table=True).attn_exp("cpu")
    assert fn is not None
    kw = dict(causal=geom["causal"], window=geom["window"], kv_chunk=KV_CHUNK)
    exact = flash_attention(q, k, v, q_pos, k_pos, exp_fn=None, **kw)
    table = flash_attention(q, k, v, q_pos, k_pos, exp_fn=fn, **kw)
    bound = t_attn.flash_abs_bound(EA_EFF, T, KV_CHUNK, float(v.abs().max()))
    err = float((exact - table).abs().max())
    assert math.isfinite(bound) and err <= bound, (geom_name, err, bound)
    assert err > 0.0  # the table path is not the exact one


# --------------------------------------------------------------------------------------
# The paper's figures and tables
# --------------------------------------------------------------------------------------


_ROWS = {}


def _rows(which):
    """Each side's rows of one paper function, computed once per module."""
    if which not in _ROWS:
        if which == "fig6":
            kw = dict(n_intervals=2, omegas=[0.05, 0.15, 0.3])
            got, got_s = tp.fig6_omega_sweep(**kw)
            want, want_s = jp.fig6_omega_sweep(**kw)
            _ROWS[which] = (got + tp.table2_ttests(got_s),
                            want + jp.table2_ttests(want_s), (got_s, want_s))
        else:
            _ROWS[which] = (getattr(tp, which)(), getattr(jp, which)(), None)
    return _ROWS[which]


def _strip_resource(derived):
    """Table 3's derived field without its resource column (VMEM / SMEM)."""
    return derived.split(";vmem=")[0].split(";smem=")[0]


@pytest.mark.parametrize("which", ["fig3_reference", "fig45_worked_examples", "fig6",
                                   "table3_synthesis", "table3_fidelity",
                                   "table3_packing"])
def test_paper_rows_equal(which):
    got, want, samples = _rows(which)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g[0], g[1], _strip_resource(str(g[2]))) == \
            (w[0], w[1], _strip_resource(str(w[2])))
    if samples is not None:  # fig6's per-omega means behind Table 2
        assert samples[0] == samples[1]
    if which == "table3_synthesis":
        for name, mf, derived in got:
            if ".omega" in name:
                n = int(derived.split("n=")[1].split(";")[0])
                sm = tc.smem_cost(mf, n)
                assert derived.endswith(f";smem={sm.image_bytes}B;fits={sm.fits}")


def test_paper_cli_prints_the_rows(capsys):
    """``python -m repro_torch.launch.paper --skip-fig6`` prints the functions'
    rows in benchmarks/run.py's order after its header line."""
    tp.main(["--skip-fig6"])
    out = capsys.readouterr().out.splitlines()
    csv = out[out.index("name,value,derived") + 1:]
    want = [r for which in ("fig3_reference", "fig45_worked_examples",
                            "table3_synthesis", "table3_fidelity", "table3_packing")
            for r in _rows(which)[0]]
    assert csv == [f"{n},{v},{d}" for n, v, d in want]


# --------------------------------------------------------------------------------------
# The quickstart
# --------------------------------------------------------------------------------------


def test_quickstart_torch_on_the_cpu_without_jax():
    """examples/quickstart_torch.py --device cpu ends with ``quickstart OK``, and
    nothing of JAX or of the JAX package was imported to run it."""
    code = (
        "import json, runpy, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}]\n"
        "sys.argv = ['quickstart_torch.py', '--device', 'cpu']\n"
        f"runpy.run_path({str(ROOT / 'examples' / 'quickstart_torch.py')!r}, "
        "run_name='__main__')\n"
        "print(json.dumps(sorted(k for k in sys.modules "
        "if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "quickstart OK"
    assert json.loads(lines[-1]) == []
