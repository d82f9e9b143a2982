#!/usr/bin/env python3
"""Count the SASS instructions of the port's CUDA kernels, loop by loop.

    python3 tools/torch_sass_count.py CHECKOUT PATTERN [PATTERN ...]
        [--source table_pack_lookup] [--dump DIR]

CHECKOUT is a checkout of the repository; its ``csrc/<source>.cu`` is built
by its own ``kernels/_build.py`` (as ``tools/torch_sass_diff.py`` does).
Every kernel whose mangled name matches one of the regular expressions
PATTERN is disassembled (``cuobjdump -sass``) and reported: its demangled
name, its instruction count, and each loop (a backward branch to an earlier
offset) with its offsets, its instruction count, its nesting depth and its
opcodes by count.  The instructions an element issues follow from the loop
counts and their trip counts (a grid-stride loop's body over the elements a
trip handles, an inner selector loop times its trip count); the report does
not guess trip counts.  ``--dump DIR`` also writes each kernel's SASS to
``DIR/<demangled name>.sass``.  Needs the CUDA toolkit (``nvcc``,
``cuobjdump``); exits non-zero without it.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))
from torch_sass_diff import library  # noqa: E402

from repro_torch.analysis.sass import functions, opcode  # noqa: E402

_BRANCH = re.compile(r"\bBRA(?:\.\S+)?\s+(?:`\()?(0x[0-9a-f]+)")


def demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if not tool:
        return {n: n for n in names}
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    return dict(zip(names, res.stdout.splitlines()))


def loops(instrs):
    """[(start offset, end offset)] of each backward branch's loop, outermost
    first."""
    found = []
    for off, text in instrs:
        m = _BRANCH.search(text)
        if m and int(m.group(1), 16) <= off:
            found.append((int(m.group(1), 16), off))
    return sorted(set(found), key=lambda se: (se[0], -se[1]))


def report(name: str, instrs, out=sys.stdout) -> None:
    body = [(o, t) for o, t in instrs if opcode(t) != "NOP"]
    print(f"{name}: {len(body)} instructions (NOPs dropped)", file=out)
    spans = loops(body)
    for s, e in spans:
        depth = sum(1 for s2, e2 in spans if s2 <= s and e <= e2 and (s2, e2) != (s, e))
        inside = [t for o, t in body if s <= o <= e]
        ops = collections.Counter(opcode(t) for t in inside)
        top = ", ".join(f"{k} {v}" for k, v in ops.most_common())
        print(f"  {'  ' * depth}loop [{s:#06x}, {e:#06x}] depth {depth}: "
              f"{len(inside)} instructions: {top}", file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout")
    ap.add_argument("patterns", nargs="+")
    ap.add_argument("--source", default="table_pack_lookup")
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        print("torch_sass_count: cuobjdump not found", file=sys.stderr)
        return 2
    funcs = functions(library(args.checkout, args.source), cuobjdump)
    names = sorted(k for k in funcs if any(re.search(p, k) for p in args.patterns))
    pretty = demangle(names)
    for k in names:
        report(pretty[k], funcs[k])
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            fn = re.sub(r"[^A-Za-z0-9_.,<>-]+", "_", pretty[k])[:150]
            with open(os.path.join(args.dump, f"{fn}.sass"), "w") as f:
                f.writelines(f"/*{o:04x}*/ {t} ;\n" for o, t in funcs[k])
    if not names:
        print(f"no kernel matches {args.patterns}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
