"""Fault-tolerant checkpointing: atomic, async, keep-K — the JAX package's
``train/checkpoint.py`` on PyTorch, with the same on-disk layout.

Layout per step:  <dir>/step_<N>/manifest.json + one .npy per leaf.
  * Atomic publish: everything is written into ``step_<N>.tmp`` then
    os.replace'd, so a crash mid-write never corrupts the latest checkpoint.
  * Async: ``save_async`` copies the tree to host memory on the caller thread
    and does the file IO on a worker thread; ``wait()`` joins before the next
    save.
  * Leaves are f32 or integer tensors.  A bf16 leaf is stored as f32 (numpy
    has no bf16; the widening is exact) and restored to bf16: ``restore``
    casts every leaf to the dtype of the matching leaf of the tree it is
    given.  Restore checks every leaf's shape.
Leaves are keyed by their path in the tree (dict keys, list indices), in the
reference's ``jax.tree`` order.

  * Mesh-elastic: a DTensor leaf is gathered whole before it is written (on
    every rank: the gather is a collective), so a checkpoint taken on one
    mesh restores onto any other mesh's placements, or off the mesh.
  * Multi-rank: only rank 0 of the default process group writes; every rank
    restores.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.parallel.sharding import is_dtensor
from repro_torch.tree import leaves_with_path, subtree, tree_map, unflatten

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _leaf_name(path) -> str:
    return _SAFE.sub("_", ".".join(path)) or "leaf"


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if is_dtensor(t):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------- save ----------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> None:
        host_tree = tree_map(_to_host, tree)  # every rank: DTensors gather
        if _rank() != 0:
            return
        self._write(step, host_tree, extra or {})

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None) -> None:
        self.wait()
        host_tree = tree_map(_to_host, tree)
        if _rank() != 0:
            return
        self._thread = threading.Thread(
            target=self._write, args=(step, host_tree, extra or {}), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_tree: Any, extra: dict) -> None:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        used = set()
        for path, leaf in leaves_with_path(host_tree):
            name = _leaf_name(path)
            while name in used:
                name += "_"
            used.add(name)
            np.save(os.path.join(tmp, name + ".npy"), leaf)
            manifest["leaves"][json.dumps([_leaf_name([k]) for k in path])] = {
                "file": name + ".npy",
                "shape": list(np.shape(leaf)),
                "dtype": str(np.asarray(leaf).dtype),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    # ------------------------------ restore --------------------------------------

    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, placements: Any = None,
                mesh=None) -> Any:
        """Rebuild ``like``'s structure from disk: each leaf a new tensor on
        the device and in the dtype of ``like``'s leaf (shapes must agree).
        ``placements`` (a tree of ``like``'s structure) with ``mesh`` lays
        each leaf out as a DTensor with its placements (a None leaf stays a
        plain tensor): the elastic path, onto any mesh."""
        from repro_torch.parallel.sharding import distribute

        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out = []
        for path, leaf in leaves_with_path(like):
            key = json.dumps([_leaf_name([k]) for k in path])
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = np.load(os.path.join(d, meta["file"]))
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            dev = leaf.to_local().device if is_dtensor(leaf) else leaf.device
            t = torch.from_numpy(arr).to(device=dev, dtype=leaf.dtype)
            pl = None if placements is None else subtree(placements, path)
            out.append(t if pl is None else distribute(t, mesh, pl))
        return unflatten(like, out)

    def restore_latest(self, like: Any, placements: Any = None, mesh=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like, placements, mesh)
