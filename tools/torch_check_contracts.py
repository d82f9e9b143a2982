#!/usr/bin/env python
"""PackLint CLI of the PyTorch port: check the port's standing contracts on
graphs.

Traces (on ``meta`` tensors: no kernel runs) every registered (mode x
function x {value, grad}) closure and checks the five rules of
``repro_torch.analysis.contracts``: f64 leakage, the kernel registry and
sync-free closures, recompile hazards, the shared-memory staging against the
packs' ``smem()`` reports, and the obs-off identity.  ``--sass`` adds the
card-only part of the kernel rule: the built library's SASS holds no f64,
local-memory or CALL instruction (needs ``nvcc`` and ``cuobjdump``).  Writes
``REPORT_torch_contracts.json`` and exits non-zero on any violation.

Usage:
    PYTHONPATH=src python tools/torch_check_contracts.py            # full matrix
    PYTHONPATH=src python tools/torch_check_contracts.py --fast     # gelu, tanh, log
    PYTHONPATH=src python tools/torch_check_contracts.py --rules smem_budget
    PYTHONPATH=src python tools/torch_check_contracts.py --fast --sass   # on the card
    PYTHONPATH=src python tools/torch_check_contracts.py --list-rules
"""

import argparse
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true",
                    help="subsample the function axis to the conformance "
                         "fast-tier trio (gelu, tanh, log)")
    ap.add_argument("--funcs", default=None,
                    help="comma-separated function subset (overrides --fast)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--e-a", type=float, default=None,
                    help="design error bound for the checked packs (default 1e-4)")
    ap.add_argument("--out", default="REPORT_torch_contracts.json",
                    help="report path ('' to skip writing)")
    ap.add_argument("--sass", action="store_true",
                    help="also scan the built kernels' SASS (needs nvcc and cuobjdump)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.analysis import contracts

    if args.list_rules:
        for name, fn in contracts.RULES.items():
            doc = (fn.__doc__ or "").strip().split("\n")[0]
            print(f"{name:<20} {doc}")
        return 0

    funcs = None
    if args.funcs:
        funcs = tuple(f.strip() for f in args.funcs.split(",") if f.strip())
    elif args.fast:
        funcs = contracts.FAST_FUNCS
    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in contracts.RULES]
        if unknown:
            print(f"unknown rules: {unknown}; have {list(contracts.RULES)}",
                  file=sys.stderr)
            return 2
    if args.sass:
        missing = [t for t in ("nvcc", "cuobjdump") if not (
            shutil.which(t) or os.path.exists(os.path.join(
                os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", t)))]
        if missing:
            print(f"--sass needs the CUDA toolkit; not found: {missing}", file=sys.stderr)
            return 2

    t0 = time.perf_counter()
    ctx = contracts.LintContext(
        e_a=args.e_a if args.e_a is not None else contracts.EA, funcs=funcs,
        sass=args.sass)
    rep = contracts.run(ctx, rules=rules)
    rep.meta["elapsed_s"] = round(time.perf_counter() - t0, 2)
    rep.meta["tier"] = "fast" if funcs is not None else "full"
    rep.meta["sass"] = args.sass

    if args.out:
        rep.to_json(args.out)
        print(f"wrote {args.out}")
    print(rep.summary())
    return 0 if rep.ok else 1


if __name__ == "__main__":
    sys.exit(main())
