"""Meshes of the port: ``torch.distributed.device_mesh.DeviceMesh`` over the
initialised process group (the JAX package's ``launch/mesh.py``).

The mesh constructors are FUNCTIONS: importing this module touches no process group.
:func:`init_process_group` joins one if none is up — from ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or as
a world of one on a free local port — with ``nccl`` on the card and ``gloo``
on the CPU.  Ranks are laid out over the mesh row-major, so the last axis
('model') varies fastest.

:func:`init_fake_process_group` joins a world of any size in ONE process:
rank 0 of a ``"fake"`` backend whose collectives move nothing.  Under it
:func:`make_production_mesh` builds the (16, 16) or (2, 16, 16) mesh, and
the dry run (``launch.dryrun``) traces a rank's step over fake tensors.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import DeviceLike, resolve_device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(device: DeviceLike = None) -> str:
    """Join the default process group unless one is up; returns the device
    type the meshes use ('cuda' or 'cpu').  On the card each rank takes the
    card ``LOCAL_RANK % device_count``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{_free_port()}",
                rank=0, world_size=1)
    return dev.type


def init_fake_process_group(world: int) -> None:
    """Make this process rank 0 of a ``world``-rank process group of the
    ``"fake"`` backend (over a ``FakeStore``: no peers, no rendezvous).  A
    fake world of another size is replaced; any other group is an error."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()!r} process group is up: the "
                               "fake world needs the process to itself")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def make_mesh(shape, axes, device: DeviceLike = None) -> DeviceMesh:
    """A ``shape`` mesh named ``axes`` over the world's ranks, which must
    number exactly ``prod(shape)``."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dev_type = resolve_device(device).type if device is not None else "cpu"
    else:
        dev_type = init_process_group(device)
    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size()
    if world != need:
        raise ValueError(
            f"a {tuple(shape)} mesh over {axes} needs a world of {need} "
            f"ranks, this one has {world} (start {need} with torchrun "
            f"--nproc_per_node ... or across hosts)")
    return DeviceMesh(dev_type, torch.arange(need).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None):
    """The reference's production meshes: (16, 16) ('data', 'model') or 2
    pods (2, 16, 16) ('pod', 'data', 'model'); a smaller world is an error
    that names the world size it needs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_debug_mesh(n_data: int = 1, n_model: int = 1, device: DeviceLike = None):
    """A small ('data', 'model') mesh for smoke runs."""
    return make_mesh((n_data, n_model), ("data", "model"), device)


def make_sharded_pack_mesh(n_shards: int, n_data: int = 1, device: DeviceLike = None):
    """A ('data', 'model') mesh whose 'model' axis is as wide as a
    ShardedPack's shard count: ``ApproxConfig(mode="sharded_pack",
    pack_shards=N)`` distributes only over a 'model' axis exactly N wide
    (``approx.table_pack._active_pack_mesh``)."""
    return make_mesh((n_data, n_shards), ("data", "model"), device)
