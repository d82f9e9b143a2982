"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file is compiled on first use into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -Xptxas -v -shared -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

``-fmad=false`` is not an optimisation flag here: the kernels must be bitwise
equal to their plain PyTorch versions, which round every product and sum on
their own.  The library name carries a hash of the sources and flags, so a
changed source is rebuilt and never loaded stale; the build writes to a
temporary name and renames, so two processes building at once do not clash.
Libraries live in ``build/`` at the root of the checkout (listed in
``.gitignore``).  Several sources are compiled in parallel, one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}
_build_seconds = 0.0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels are built on the machine with the card; CPU tensors use the "
        "plain PyTorch versions and never reach this build")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:12]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _start(name: str):
    """Start one nvcc; returns (process, temporary output, final library)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _lib_path(name)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def build(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Compile (if not yet built) and load each ``csrc/<name>.cu``, all nvcc
    processes started together.  Raises ``RuntimeError`` with nvcc's output
    if a build fails."""
    global _build_seconds
    with _lock:
        todo = [n for n in names if n not in _libs and not _lib_path(n).exists()]
        if todo:
            t0 = time.perf_counter()
            procs = {n: _start(n) for n in todo}
            failed = []
            for n, (proc, tmp, out) in procs.items():
                log, _ = proc.communicate()
                _logs[n] = log
                if proc.returncode != 0:
                    failed.append(f"nvcc failed for {n}.cu:\n{log}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, out)
            _build_seconds += time.perf_counter() - t0
            if failed:
                raise RuntimeError("\n".join(failed))
        for n in names:
            if n not in _libs:
                _libs[n] = ctypes.CDLL(str(_lib_path(n)))
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build([name])[name]


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v`` register and shared-memory lines) of this
    process's build of ``name``; empty if the library was already on disk."""
    return _logs.get(name, "")


def build_seconds() -> float:
    """Wall seconds this process spent in nvcc (the port's counterpart of the
    JAX engines' compile time)."""
    return _build_seconds
