"""The built kernels' SASS, split by function (``cuobjdump -sass``), and the
instructions PackLint checks in them.  ``tools/torch_sass_count.py`` reads
the disassembly through :func:`functions` too.  Needs the CUDA toolkit
(``cuobjdump``), which only the machine with the card has.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from typing import Dict, List, Tuple

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")

# f64 arithmetic (DADD, DMUL, DFMA, DSETP, DMNMX, DSET, DMMA) and the f64
# reciprocal / square-root seeds
_F64_OPS = re.compile(r"^(DADD|DMUL|DFMA|DSETP|DSET|DMNMX|DMMA)\b|^MUFU\.\w*64H\b")
_F64_CVT = re.compile(r"^(F2F|I2F|F2I)\b.*\.F64\b")
# local memory: spills or a stack
_LOCAL = re.compile(r"^(LDL|STL)\b")
# a call: to an external function (printf's vprintf, __assertfail, malloc),
# to a function outside the kernel, or to a subroutine that is none of the
# compiler's arithmetic routines below
_CALL = re.compile(r"^CALL\b")
_CALL_TARGET = re.compile(r"\bCALL\.REL\S*\s+(0x[0-9a-f]+)")

# the compiler's arithmetic subroutines a kernel calls inside itself, by the
# opcodes of their bodies: the 64-bit unsigned division (a ``long long``
# division or remainder) and the IEEE f32 division's slow path (a ``/``
# whose fast path cannot round the quotient)
SUBROUTINES = {
    "div64": lambda ops: ("MUFU.RCP" in ops and any(o.startswith("I2F.U64") for o in ops)
                          and any(o.startswith("F2I.U64") for o in ops)),
    "fdiv": lambda ops: ("MUFU.RCP" in ops and any(o.startswith("FFMA.R") for o in ops)
                         and not any(o.startswith("I2F.U64") for o in ops)),
}


def cuobjdump_path() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("cuobjdump not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def functions(lib: str, cuobjdump: str = None) -> Dict[str, List[Tuple[int, str]]]:
    """{mangled kernel name: [(offset, instruction text)]} of a built
    library."""
    sass = subprocess.run([cuobjdump or cuobjdump_path(), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(text: str) -> str:
    """The opcode of an instruction, its predicate dropped (``@!P0 BRA`` ->
    ``BRA``), its modifiers kept (``LDS.128``)."""
    parts = text.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0] if parts else ""


def subroutine(instrs: List[Tuple[int, str]], text: str) -> str:
    """Which of :data:`SUBROUTINES` a ``CALL`` calls: a relative call to a
    subroutine of the same function, whose body up to its ``RET`` holds no
    call or local-memory access and matches the routine; "" otherwise."""
    m = _CALL_TARGET.search(text)
    if not m:
        return ""
    target = int(m.group(1), 16)
    body = []
    for off, t in instrs:
        if off >= target:
            op = opcode(t)
            body.append(op)
            if op.startswith("RET"):
                break
    if not body or not body[-1].startswith("RET") or any(
            _CALL.search(o) or _LOCAL.search(o) for o in body):
        return ""
    ops = set(body)
    return next((name for name, match in SUBROUTINES.items() if match(ops)), "")


def forbidden(instrs: List[Tuple[int, str]]) -> Dict[str, List[str]]:
    """The hazardous instructions of one kernel, by class: ``f64``,
    ``local`` (LDL / STL: a stack or spills) and ``call``; a call to one of
    the compiler's :data:`SUBROUTINES` is counted apart, under its name (it
    is the kernel's own code, not a call out of it)."""
    out = {"f64": [], "local": [], "call": [], **{k: [] for k in SUBROUTINES}}
    for _, text in instrs:
        op = opcode(text)
        if _F64_OPS.search(op) or _F64_CVT.search(op):
            out["f64"].append(op)
        elif _LOCAL.search(op):
            out["local"].append(op)
        elif _CALL.search(op):
            out[subroutine(instrs, text) or "call"].append(op)
    return out


def kernel_name(mangled: str, known) -> str:
    """Which of the ``known`` ``__global__`` kernel names a mangled name is
    (its nested name ``<len><name>`` followed by its template or end), or
    the mangled name itself."""
    for k in sorted(known, key=len, reverse=True):
        if re.search(rf"{len(k)}{k}[IE]", mangled):
            return k
    return mangled
