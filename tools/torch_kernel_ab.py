#!/usr/bin/env python3
"""Time the port's CUDA kernels of two or more checkouts in turns on one card.

    python3 tools/torch_kernel_ab.py PARENT_DIR CHANGE_DIR [MORE_DIRS...] [--rounds 2]
        [--phases pack,quant_poly,routed,routed_poly,folded,sharded]

Each directory is a checkout of the repository (for example a ``git archive``
of the parent commit unpacked into a git-ignored directory).  For every round
the checkouts run in turns, the order reversed every other round (parent,
change, change, parent, ...); each run is a fresh process that builds that
checkout's ``src/repro_torch/csrc`` with its own ``kernels/_build.py`` and
times every kernel the checkout's package has.  The timing is not this
tool's own: each run calls the timing phases of the ``chip_smoke.py`` beside
this tool (``timing_phase`` and, where the checkout has them, the quantized
and polynomial kernels' ``quant_poly_timing_phase``, the routed kernels'
``routed_timing_phase``, the folded kernels' ``folded_timing_phase`` and
the sharded kernels' ``sharded_timing_phase``) with the checkout's package on
``sys.path``, so every checkout is timed by one method, at the main path's
shapes, over stablelm-3b's packs.  ``--phases`` keeps the named phases only
(all by default).  The card's name and power limit are printed
with the table of per-run kernel times and medians (us).  Needs a card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Runs with one checkout's package on sys.path; argv: this repository's root,
# the nvidia-smi line, the phases to time.  Prints one JSON line of kernel us.
_TIMER = r"""
import dataclasses, importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.kernels import table_pack_lookup as K
from repro_torch.models import get_config

_build.build(["table_pack_lookup"])
approx = get_config("stablelm-3b").approx
pack = dataclasses.replace(approx, mode="table_pack").pack("cuda")
phases = sys.argv[3].split(",")
routed = importlib.util.find_spec("repro_torch.kernels.routed_pack_lookup")
rows = {}
if "pack" in phases:
    rows.update(cs.timing_phase(pack, dataclasses.replace(approx, mode="table_pallas"),
                                sys.argv[2]))
if "quant_poly" in phases and hasattr(K, "quant_pack_lookup"):
    rows.update(cs.quant_poly_timing_phase(approx.quant_pack("cuda"),
                                           approx.poly_pack("cuda"), sys.argv[2]))
if "routed" in phases and routed:
    rows.update(cs.routed_timing_phase(((pack, 14), (approx.quant_pack("cuda"), 22)),
                                       sys.argv[2]))
if "routed_poly" in phases and routed:
    from repro_torch.kernels import routed_pack_lookup as R
    if hasattr(R, "routed_poly_pack_lookup"):
        poly = approx.poly_pack("cuda")
        d = poly.degrees[poly.fn_id("silu")]
        rows.update(cs.routed_timing_phase(((poly, 10 + 6 * (d + 1) + 5 * d),),
                                           sys.argv[2]))
if "folded" in phases and hasattr(K, "folded_pack_lookup"):
    rows.update(cs.folded_timing_phase(
        dataclasses.replace(approx, mode="folded_pack").pack("cuda"), sys.argv[2]))
if "sharded" in phases and hasattr(K, "sharded_pack_lookup"):
    rows.update(cs.sharded_timing_phase(approx, sys.argv[2]))
print(json.dumps({k: r["ms"] * 1e3 for k, r in rows.items()}))
"""


PHASES = ("pack", "quant_poly", "routed", "routed_poly", "folded", "sharded")


def run_one(checkout: str, smi_line: str, phases: str) -> dict:
    checkout = os.path.abspath(checkout)
    env = dict(os.environ, PYTHONPATH=os.path.join(checkout, "src"))
    out = subprocess.run([sys.executable, "-c", _TIMER, REPO, smi_line, phases],
                         cwd=checkout, env=env, capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        raise SystemExit(f"{checkout}: timer failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated timing phases to run (default: all)")
    args = ap.parse_args(argv)
    if len(args.checkouts) < 2:
        ap.error("give at least two checkouts")
    unknown = set(args.phases.split(",")) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; choose from {PHASES}")
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    smi_line = smi.stdout.strip()
    print(f"card: {smi_line}")
    runs = {c: [] for c in args.checkouts}
    for r in range(args.rounds):
        order = args.checkouts if r % 2 == 0 else args.checkouts[::-1]
        for c in order:
            runs[c].append(run_one(c, smi_line, args.phases))
            print(f"round {r} {c}: " + ", ".join(
                f"{k} {v:.3f}" for k, v in runs[c][-1].items()), flush=True)
    names = list(dict.fromkeys(k for c in args.checkouts for rr in runs[c] for k in rr))
    print("median us | " + " | ".join(args.checkouts))
    for k in names:
        cells = [f"{statistics.median(rr[k] for rr in runs[c]):.3f}"
                 if all(k in rr for rr in runs[c]) else "-" for c in args.checkouts]
        print(f"{k} | " + " | ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
