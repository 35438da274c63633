"""Device meshes and joining the process group.

Port of ``repro/launch/mesh.py`` (and ``repro._compat.make_mesh``).
Functions only: importing this module touches no device and no process
group.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names over the ranks of the default process group, one
rank per card.

Topology of the reference's production mesh: 256 chips as a (16, 16) =
(data, model) grid; multi-pod adds the leading ``pod`` axis (2 x 256 =
512 ranks).  :func:`make_production_mesh` raises unless the world has
exactly that many ranks (the dry run's fake group included): it is only
valid on hardware of that size.

:func:`join` starts the process group from the launcher's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` /
``MASTER_PORT`` as ``torchrun`` sets them) or from an explicit store: NCCL
on CUDA, after ``torch.cuda.set_device(local_rank)``; gloo with
``device="cpu"``.  A missing card or rank raises; nothing falls back.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

__all__ = ["make_mesh", "make_production_mesh", "make_host_mesh",
           "world_size", "join", "leave"]


def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type() -> str:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "launch.mesh.join() first")
    backend = dist.get_backend()
    return "cuda" if backend == "nccl" else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A mesh of ``shape`` named ``axes`` over the whole world, whose size
    must equal the product of ``shape`` (``init_device_mesh``).  The
    device type follows the group's backend unless given."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= int(s)
    if n != world_size():
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} ranks; "
                         f"the world has {world_size()}")
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The reference's (16, 16) (data, model) mesh, or (2, 16, 16) (pod,
    data, model); raises unless the world has exactly 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    if world_size() != need:
        raise RuntimeError(
            f"the production mesh {shape} needs a world of {need} ranks; "
            f"this one has {world_size()} (it is only valid on hardware of "
            f"that size -- use launch.dryrun for a fake one)")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(n: Optional[int] = None, axis: str = "data",
                   device_type: Optional[str] = None):
    """A 1-D mesh over the world (``n`` must be its size when given)."""
    return make_mesh((n or world_size(),), (axis,), device_type)


def join(device=None, *, rank: Optional[int] = None,
         world: Optional[int] = None, store=None,
         local_rank: Optional[int] = None, timeout=None) -> torch.device:
    """Join the default process group and return this rank's device.
    Ranks, world size and local rank come from the arguments or from
    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``; without ``store`` the
    group rendezvouses at ``MASTER_ADDR:MASTER_PORT`` (``env://``).  On
    CUDA (the default) the rank's card is ``cuda:<local_rank>``, set
    before NCCL starts; ``device="cpu"`` uses gloo.  ``timeout`` (a
    ``timedelta``) bounds every collective."""
    import torch.distributed as dist
    from repro_torch.kernels._backend import resolve_device
    dev = resolve_device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world = int(os.environ["WORLD_SIZE"]) if world is None else world
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} wants card {local_rank}; this "
                               f"host has {torch.cuda.device_count()}")
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
        backend = "nccl"
    else:
        backend = "gloo"
    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_rank() != rank:
            raise RuntimeError("a different process group is already "
                               "running")
        return dev
    kw = {"store": store} if store is not None else {
        "init_method": "env://"}
    if timeout is not None:
        kw["timeout"] = timeout
    dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    return dev


def leave() -> None:
    """Destroy the default process group, if one is running."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
