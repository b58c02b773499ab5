"""The ('dp', 'state') device mesh and the placement of tensors on it.

Counterpart of ``tensornetworks_tpu/parallel/mesh.py``. The JAX package
builds a ``jax.sharding.Mesh`` and places arrays with ``NamedSharding``; a
sharded JAX array is one global array. The port is SPMD with one process per
rank: the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
initialised world, and a sharded tensor is this rank's local shard, in the
order of the leading (global) bits. ``state_shard``, ``data_shard``,
``replicate`` and ``gather_full`` take the place of the ``NamedSharding``
placements.

The mesh's device type follows the world's backend: ``nccl`` meshes are
``cuda`` meshes; a ``gloo`` mesh is a ``cpu`` mesh, whose collectives take
host tensors (``parallel/comm.py`` stages a CUDA tensor through host memory
for them).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

STATE_AXIS = "state"
DATA_AXIS = "dp"


def make_mesh(n_devices: Optional[int] = None, dp: int = 1) -> DeviceMesh:
    """2D ('dp', 'state') mesh over the first ``n_devices`` ranks of the
    initialised world (all of them by default); every rank of the world
    calls it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.launch.spawn, or torchrun)")
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} available")
    if n % dp != 0:
        raise ValueError(f"n_devices={n} not divisible by dp={dp}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.arange(n, dtype=torch.int).reshape(dp, n // dp)
    return DeviceMesh(device_type, grid, mesh_dim_names=(DATA_AXIS, STATE_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along a mesh axis."""
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along a mesh axis (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def _chunk(x: torch.Tensor, parts: int, index: int, dim: int) -> torch.Tensor:
    size = x.shape[dim]
    if size % parts:
        raise ValueError(f"axis {dim} of extent {size} is not divisible by {parts} shards")
    step = size // parts
    return x.narrow(dim, index * step, step)


def state_shard(x: torch.Tensor, mesh: DeviceMesh, dim: int = 0) -> torch.Tensor:
    """This rank's shard of the full tensor ``x`` along ``dim``, split over
    the ``state`` axis (a view)."""
    return _chunk(x, axis_size(mesh, STATE_AXIS), axis_index(mesh, STATE_AXIS), dim)


def data_shard(x: torch.Tensor, mesh: DeviceMesh, dim: int = 0) -> torch.Tensor:
    """This rank's shard of ``x`` along ``dim``, split over the ``dp`` axis."""
    return _chunk(x, axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS), dim)


def replicate(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``x`` as the mesh's first rank holds it, on every rank (a broadcast)."""
    from .comm import broadcast

    return broadcast(x, src=int(mesh.mesh.reshape(-1)[0]))


def gather_full(x: torch.Tensor, mesh: DeviceMesh, dim: int = 0) -> torch.Tensor:
    """The full tensor from each rank's ``state`` shard along ``dim`` (an
    all-gather over the state axis)."""
    from .comm import all_gather

    return torch.cat(all_gather(x, mesh).unbind(0), dim=dim)
