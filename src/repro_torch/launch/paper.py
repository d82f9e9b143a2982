"""The paper's experiment on the port: Fig. 3 (Reference), Figs. 4-5 (worked
examples), Fig. 6 (omega sweep), Table 2 (t-tests) and Table 3 (synthesis /
resource model, fixed-point fidelity, mixed-width packing).

  PYTHONPATH=src python -m repro_torch.launch.paper [--skip-fig6] [--full]

The port's counterpart of the JAX package's ``benchmarks/paper_figs.py``, run
the way its ``benchmarks/run.py`` runs it: each function prints a
human-readable block and returns CSV rows (name, value, derived), which the
CLI prints at the end in the same order.  The one difference is Table 3's
resource column: the bytes of the table kernels' shared-memory staging image
and whether it fits a block's 48 KB, where the reference reports TPU VMEM.
Host numpy in f64, as the reference; no device is used.  ``--full`` uses the
paper's population sizes (slower).  This is the paper's experiment, not a
benchmark: it writes no file.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np

from repro_torch.configs.tabla_paper import (
    E_A_FIG3,
    E_A_TABLE2,
    E_A_WORKED,
    OMEGA_SWEEP,
    TABLE2_CELLS,
    TABLE3_CELLS,
)
from repro_torch.core import (
    PAPER_FORMATS,
    SecondDerivMax,
    binary_split,
    bram_count,
    build_table,
    get_function,
    hierarchical_split,
    outperforms,
    reference_spacing,
    sequential_split,
    smem_cost,
)
from repro_torch.core.packing import quantize_table

Rows = List[tuple]


def fig3_reference() -> Rows:
    """Fig. 3: Reference approach on log(x) over [0.625, 15.625), Ea=1.25e-4."""
    fn = get_function("log")
    lo, hi = 0.625, 15.625
    r = reference_spacing(fn, E_A_FIG3, lo, hi)
    ts = build_table("log", E_A_FIG3, lo, hi, algorithm="reference")
    err = ts.max_error_on_grid()
    print(f"[fig3] delta={r.delta:.6f} (paper ~0.019)  M_F={r.footprint} "
          f"(paper 770)  measured_max_err={err:.3e} <= Ea={E_A_FIG3:g}")
    return [("fig3.delta", r.delta, "paper~0.019"),
            ("fig3.M_F", r.footprint, "paper=770"),
            ("fig3.max_err", err, f"Ea={E_A_FIG3:g}")]


def fig45_worked_examples() -> Rows:
    """Sec. 5.1-5.3 worked examples on log(x), Ea=1.22e-4, omega=0.3."""
    lo, hi = 0.625, 15.625
    ref = reference_spacing(get_function("log"), E_A_WORKED, lo, hi).footprint
    rows: Rows = [("fig45.reference.M_F", ref, "paper=770")]
    runs = [
        ("binary", binary_split("log", E_A_WORKED, lo, hi, 0.3), 182),
        ("hierarchical",
         hierarchical_split("log", E_A_WORKED, lo, hi, 0.3, epsilon=0.015), 161),
        ("sequential",
         sequential_split("log", E_A_WORKED, lo, hi, 0.3, epsilon=0.3), 146),
    ]
    for name, sr, paper_mf in runs:
        red = 100.0 * (ref - sr.footprint) / ref
        ts = build_table("log", E_A_WORKED, lo, hi, algorithm=name, omega=0.3,
                         split_result=sr)
        err = ts.max_error_on_grid()
        print(f"[fig4/5] {name:13s} M_F={sr.footprint:4d} (paper {paper_mf})  "
              f"reduction={red:.1f}%  n={sr.n_intervals}  err={err:.3e}")
        rows += [(f"fig45.{name}.M_F", sr.footprint, f"paper={paper_mf}"),
                 (f"fig45.{name}.reduction_pct", round(red, 1), ""),
                 (f"fig45.{name}.max_err", err, f"Ea={E_A_WORKED:g}")]
    return rows


def _random_subintervals(lo, hi, n, rng):
    """Population X: random sub-intervals of [lo, hi) (paper Sec. 5.4)."""
    out = []
    for _ in range(n):
        a, b = np.sort(rng.uniform(lo, hi, 2))
        if b - a < 0.05 * (hi - lo):
            b = min(hi, a + 0.05 * (hi - lo))
            a = max(lo, b - 0.05 * (hi - lo))
        out.append((float(a), float(b)))
    return out


def fig6_omega_sweep(n_intervals: int = 15, omegas=None, eps_frac: float = 1 / 200,
                     seed: int = 0) -> tuple[Rows, Dict]:
    """Fig. 6: mean DeltaM_F over random sub-intervals vs omega, per algorithm."""
    omegas = omegas or OMEGA_SWEEP[1::2]
    rng = np.random.default_rng(seed)
    rows: Rows = []
    samples: Dict[str, Dict[str, list]] = {}  # fn -> alg -> [mean red per omega]
    for fname, (lo, hi) in TABLE2_CELLS.items():
        fn = get_function(fname)
        oracle = SecondDerivMax(fn, lo, hi)
        pop = _random_subintervals(lo, hi, n_intervals, rng)
        per_alg = {"binary": [], "hierarchical": [], "sequential": []}
        for omega in omegas:
            reds = {a: [] for a in per_alg}
            for (a, b) in pop:
                ref = reference_spacing(oracle, E_A_TABLE2, a, b).footprint
                eps = (b - a) * eps_frac
                rs = {
                    "binary": binary_split(fn, E_A_TABLE2, a, b, omega,
                                           oracle=oracle),
                    "hierarchical": hierarchical_split(
                        fn, E_A_TABLE2, a, b, omega, epsilon=eps, oracle=oracle),
                    "sequential": sequential_split(
                        fn, E_A_TABLE2, a, b, omega, epsilon=eps * 4,
                        oracle=oracle),
                }
                for alg, sr in rs.items():
                    reds[alg].append(100.0 * (ref - sr.footprint) / max(ref, 1))
            for alg in per_alg:
                per_alg[alg].append(float(np.mean(reds[alg])))
        samples[fname] = per_alg
        for alg in per_alg:
            m = float(np.max(per_alg[alg]))
            rows.append((f"fig6.{fname}.{alg}.max_mean_reduction_pct",
                         round(m, 1), f"omegas={len(omegas)}"))
        print(f"[fig6] {fname:8s} max mean reduction: "
              + "  ".join(f"{a}={np.max(v):.1f}%" for a, v in per_alg.items()))
    return rows, samples


def table2_ttests(samples: Dict) -> Rows:
    """Table 2: pairwise right/left-tailed two-sample t-tests per function.
    Groups G1/G2/G3 = binary/hierarchical/sequential mean reductions over omega."""
    rows: Rows = []
    pairs = [("binary", "hierarchical"), ("binary", "sequential"),
             ("hierarchical", "sequential")]
    print("[table2] pair-wise t-tests (right_h, left_h); (0,1) => G2 wins")
    for fname, per_alg in samples.items():
        for g1, g2 in pairs:
            r, l = outperforms(per_alg[g1], per_alg[g2])
            rows.append((f"table2.{fname}.{g1}_vs_{g2}", f"{r}{l}",
                         "01=G2 outperforms"))
            print(f"   {fname:8s} ({g1[:4]},{g2[:4]}): right={r} left={l}")
    return rows


def table3_fidelity() -> Rows:
    """Table 3 fixed-point path: quantize inputs per (S,W,F) in-format and stored
    range values per out-format, then verify end-to-end error stays within
    Ea + input-quant*max|f'| + output-quant (the hardware error budget)."""
    rows: Rows = []
    ea = E_A_TABLE2
    for fname, (lo, hi) in TABLE3_CELLS.items():
        if fname not in PAPER_FORMATS:
            continue
        in_fmt, out_fmt = PAPER_FORMATS[fname]
        fn = get_function(fname)
        ts = build_table(fname, ea, lo, hi, algorithm="hierarchical", omega=0.1)
        # quantize the stored table like the BRAM would hold it
        ts_q = ts.__class__(**{**ts.__dict__, "values": out_fmt.quantize(ts.values)})
        xs = np.linspace(lo, hi - 1e-9, 20001)
        xq = in_fmt.quantize(xs)
        y = out_fmt.quantize(ts_q.eval(xq))
        exact = np.asarray(fn.f(xs))
        err = float(np.max(np.abs(y - exact)))
        d1 = float(np.max(np.abs(np.asarray(fn.d1f(xs)))))
        budget = ea + in_fmt.resolution * d1 + 2 * out_fmt.resolution
        ok = err <= budget * 1.01
        rows.append((f"table3_fixedpoint.{fname}.max_err", f"{err:.3e}",
                     f"budget={budget:.3e};ok={ok}"))
        print(f"[table3-fp] {fname:8s} err={err:.3e} <= budget={budget:.3e} "
              f"({'OK' if ok else 'VIOLATION'})")
        assert ok, (fname, err, budget)
    return rows


def table3_packing() -> Rows:
    """Beyond-paper (the paper's stated future work, Sec. 8): mixed-width
    quantized table packing.  Reports bits/entry and total bit reduction vs the
    32-bit Reference at the paper's Ea and at the framework's activation Ea."""
    rows: Rows = []
    cells = [("log", (0.625, 15.625)), ("tanh", (-8.0, 8.0)),
             ("gelu", (-8.0, 8.0)), ("silu", (-10.0, 10.0))]
    for ea, tag in [(E_A_TABLE2, "paperEa"), (1e-4, "mlEa")]:
        for name, (lo, hi) in cells:
            qt = quantize_table(name, ea, lo, hi, omega=0.1)
            err = qt.max_error_on_grid(n=50_001)
            assert err <= ea * 1.001, (name, ea, err)
            ref = reference_spacing(get_function(name), ea, lo, hi)
            bpe = qt.footprint_bits / qt.base.footprint
            total = 100.0 * (1 - qt.footprint_bits / (32.0 * ref.footprint))
            rows.append((f"packing.{tag}.{name}.bits_per_entry", round(bpe, 1),
                         f"total_red_vs_ref32={total:.1f}%"))
            print(f"[packing] {tag:7s} {name:6s} bits/entry={bpe:4.1f} "
                  f"(-{(1 - bpe / 32) * 100:.0f}% vs 32b) "
                  f"total={total:.1f}% vs 32b reference; err={err:.2e}<=Ea")
    return rows


def table3_synthesis() -> Rows:
    """Table 3: memory footprint + BRAM reductions at increasing interval counts,
    plus the table kernels' shared-memory staging report (the port's resource
    model, where the reference reports TPU VMEM): the image's bytes and
    whether it fits a block's 48 KB."""
    rows: Rows = []
    for fname, (lo, hi) in TABLE3_CELLS.items():
        fn = get_function(fname)
        oracle = SecondDerivMax(fn, lo, hi)
        ref = reference_spacing(oracle, E_A_TABLE2, lo, hi).footprint
        ref_brams = bram_count(ref)
        print(f"[table3] {fname:8s} reference M_F={ref} BRAM={ref_brams}")
        rows.append((f"table3.{fname}.ref.M_F", ref, f"BRAM={ref_brams}"))
        for omega in (0.5, 0.3, 0.1, 0.02):
            sr = hierarchical_split(fn, E_A_TABLE2, lo, hi, omega,
                                    epsilon=(hi - lo) / 500, oracle=oracle)
            mf = sr.footprint
            dm = 100.0 * (ref - mf) / ref
            db = 100.0 * (ref_brams - bram_count(mf)) / ref_brams
            sm = smem_cost(mf, sr.n_intervals)
            rows.append((f"table3.{fname}.omega{omega}.M_F", mf,
                         f"n={sr.n_intervals};dMF={dm:.0f}%;dBRAM={db:.0f}%;"
                         f"smem={sm.image_bytes}B;fits={sm.fits}"))
            print(f"    omega={omega:4.2f} n={sr.n_intervals:3d} M_F={mf:6d} "
                  f"dMF={dm:5.1f}% dBRAM={db:5.1f}% "
                  f"SMEM={sm.image_bytes / 1024:.1f}KiB "
                  f"({'staged' if sm.fits else 'past the budget'})")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale populations (slow)")
    ap.add_argument("--skip-fig6", action="store_true",
                    help="skip Fig. 6's omega sweep and Table 2's t-tests on it")
    args = ap.parse_args(argv)

    t0 = time.time()
    rows = []
    rows += fig3_reference()
    rows += fig45_worked_examples()
    if not args.skip_fig6:
        n = 100 if args.full else 12
        omegas = None if args.full else [0.01, 0.03, 0.05, 0.08, 0.12, 0.16,
                                         0.2, 0.24, 0.27, 0.3]
        fig6_rows, samples = fig6_omega_sweep(
            n_intervals=n, omegas=omegas,
            eps_frac=(1 / 1000 if args.full else 1 / 150))
        rows += fig6_rows
        rows += table2_ttests(samples)
    rows += table3_synthesis()
    rows += table3_fidelity()
    rows += table3_packing()

    print(f"\n# total paper time: {time.time() - t0:.1f}s")
    print("name,value,derived")
    for name, value, derived in rows:
        print(f"{name},{value},{derived}")


if __name__ == "__main__":
    main()
