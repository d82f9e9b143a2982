#!/usr/bin/env python3
"""Compare the compiled SASS of the port's CUDA kernels in two checkouts.

    python3 tools/torch_sass_diff.py PARENT_DIR CHANGE_DIR [--source table_pack_lookup]

Each directory is a checkout of the repository (for example a ``git archive``
of the parent commit unpacked into a git-ignored directory).  Each checkout's
``csrc/<source>.cu`` is built by that checkout's own ``kernels/_build.py``
(in a fresh process, into the checkout's ``build/``), and ``cuobjdump -sass``
of both libraries is split by kernel function.  Instruction offsets and
the column padding are dropped, so a kernel whose instructions and
encodings are the same in both builds counts as identical wherever the
linker placed it and whatever else the library holds.  Prints the counts
of identical and different kernels, each different kernel with its first
differing line, and the kernels found in one build only.  Needs the CUDA
toolkit (``nvcc``, ``cuobjdump``); exits non-zero without it.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

_BUILD = ("import sys; from repro_torch.kernels import _build; "
          "print(_build._lib_path(sys.argv[1])); _build.build([sys.argv[1]])")


def library(checkout: str, source: str) -> str:
    """Build ``source`` in ``checkout`` with its own ``_build``; its path."""
    checkout = os.path.abspath(checkout)
    env = dict(os.environ, PYTHONPATH=os.path.join(checkout, "src"))
    out = subprocess.run([sys.executable, "-c", _BUILD, source], cwd=checkout, env=env,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise SystemExit(f"{checkout}: build failed:\n{out.stderr[-4000:]}")
    return out.stdout.strip().splitlines()[0]


def kernels(cuobjdump: str, lib: str) -> dict:
    """{mangled kernel name: its SASS lines without offsets}.  The anonymous
    namespace's tag, which nvcc derives from the source file, is dropped
    from every name."""
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    sass = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", sass)
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = []
        elif cur is not None:
            # cuobjdump pads the columns to the widest instruction of the
            # whole library: compare the words, encodings included
            out[cur].append(" ".join(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--source", default="table_pack_lookup")
    args = ap.parse_args(argv)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        print("torch_sass_diff: cuobjdump not found", file=sys.stderr)
        return 2
    p = kernels(cuobjdump, library(args.parent, args.source))
    c = kernels(cuobjdump, library(args.change, args.source))
    same = [k for k in p if k in c and p[k] == c[k]]
    diff = [k for k in p if k in c and p[k] != c[k]]
    print(f"identical SASS: {len(same)} of {len(p)} parent kernels")
    print(f"different: {len(diff)}")
    for k in diff:
        first = next((i for i, (a, b) in enumerate(zip(p[k], c[k])) if a != b),
                     min(len(p[k]), len(c[k])))
        print(f"  {k} ({len(p[k])} -> {len(c[k])} lines; first difference at line "
              f"{first}: {p[k][first:first + 1]} -> {c[k][first:first + 1]})")
    print(f"only in parent: {[k for k in p if k not in c]}")
    print(f"only in change: {[k for k in c if k not in p]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
