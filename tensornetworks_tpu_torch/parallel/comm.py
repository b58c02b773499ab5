"""The collectives of the distributed path, on ``torch.distributed``.

Counterparts of the JAX package's ``shard_map`` collectives:

- ``lax.axis_index``      → ``mesh.axis_index`` (``DeviceMesh.get_local_rank``);
- ``lax.ppermute`` over XOR partners → ``exchange``: one
  ``dist.batch_isend_irecv`` with the partner's global rank. The pairing
  is its own inverse, so the backward is the same exchange of the cotangent;
- ``lax.all_gather``      → ``all_gather`` (``dist.all_gather_into_tensor``),
  which carries no gradient: the port gathers only what no gradient flows
  through (the Stein matvec runs inside its quadratic form's own backward,
  the sampler's row marginals feed a CDF);
- ``lax.psum``            → ``all_reduce`` (no gradient) and
  ``psum_replicated``, whose backward is the identity: its output is
  consumed the same way on every rank (a replicated loss, the sampler's
  rows), so each rank's cotangent already is the cotangent of its own
  summand, and summing the cotangents would multiply the gradient by D.

Transport follows from the group's backend and the tensor's device, never
from a failure: NCCL takes CUDA tensors; ``gloo`` takes host tensors, so a
CUDA tensor is copied to the host, sent, and the result copied back (which
changes no bit). Complex tensors travel as their real view.

``BYTES`` counts, per collective kind, the bytes this rank puts into the
collectives (the payload it sends, before any staging); ``reset_bytes``
zeroes it. ``MeshReducer`` is the reduction a training loop needs on a
mesh: parameter gradients summed over ``state`` and averaged over ``dp``,
sums over the state shards, one writer and a barrier.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import DATA_AXIS, STATE_AXIS, axis_size

# The gathering collective under its current name (``all_gather_into_tensor``
# before torch 2.13, a deprecated alias since).
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

BYTES: Dict[str, int] = {"exchange": 0, "all_gather": 0, "all_reduce": 0, "broadcast": 0}


def reset_bytes() -> None:
    for k in BYTES:
        BYTES[k] = 0


def transport(device) -> str:
    """How the world's collectives move a tensor on ``device``: ``nccl``,
    ``gloo``, or ``gloo via host`` (a CUDA tensor staged through host memory)."""
    backend = dist.get_backend()
    if backend == "gloo" and torch.device(device).type == "cuda":
        return "gloo via host"
    return str(backend)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_wire(t: torch.Tensor, group) -> torch.Tensor:
    """The contiguous real tensor the backend sends for ``t``."""
    w = torch.view_as_real(t) if t.is_complex() else t
    w = w.contiguous()
    return w.cpu() if _staged(t, group) else w


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    w = w.to(like.device)
    return torch.view_as_complex(w) if like.is_complex() else w


def _count(kind: str, t: torch.Tensor) -> None:
    BYTES[kind] += t.numel() * t.element_size()


def partner_rank(mesh: DeviceMesh, bit: int, axis: str = STATE_AXIS) -> int:
    """The global rank whose coordinate along ``axis`` is this rank's XOR
    ``bit`` (its other coordinates equal)."""
    coord = list(mesh.get_coordinate())
    j = mesh.mesh_dim_names.index(axis)
    coord[j] ^= bit
    return int(mesh.mesh[tuple(coord)])


def _exchange(x: torch.Tensor, peer: int) -> torch.Tensor:
    send = _to_wire(x, None)
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, peer),
                                   dist.P2POp(dist.irecv, recv, peer)])
    for req in reqs:
        req.wait()
    _count("exchange", send)
    return _from_wire(recv, x)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, peer):
        ctx.peer = peer
        return _exchange(x, peer)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.peer), None


def exchange(x: torch.Tensor, mesh: DeviceMesh, bit: int, axis: str = STATE_AXIS) -> torch.Tensor:
    """The partner's ``x``, the partner being the rank whose ``axis``
    coordinate differs from this one's in ``bit`` (``lax.ppermute`` over
    the pairs (i, i ^ bit)); differentiable."""
    return _Exchange.apply(x, partner_rank(mesh, bit, axis))


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str = STATE_AXIS) -> torch.Tensor:
    """(D, *x.shape): every rank's ``x`` along ``axis``, in coordinate
    order. No gradient."""
    group = mesh.get_group(axis)
    send = _to_wire(x.detach(), group)
    d = axis_size(mesh, axis)
    send = send.reshape((1,) + tuple(send.shape))
    out = torch.empty((d,) + tuple(send.shape[1:]), dtype=send.dtype, device=send.device)
    _all_gather_single(out, send, group=group)  # concatenates along dim 0
    _count("all_gather", send)
    return _from_wire(out, x)


def all_reduce(x: torch.Tensor, mesh: Optional[DeviceMesh] = None,
               axis: Optional[str] = STATE_AXIS) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` of ``mesh`` (over the whole world
    with ``mesh=None``), as a new tensor. No gradient."""
    group = mesh.get_group(axis) if mesh is not None else None
    w = _to_wire(x.detach(), group)
    if w.data_ptr() == x.data_ptr():
        w = w.clone()
    dist.all_reduce(w, group=group)
    _count("all_reduce", w)
    return _from_wire(w, x)


class _ReplicatedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum_replicated(x: torch.Tensor, mesh: DeviceMesh, axis: str = STATE_AXIS) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, differentiable for an output that
    every rank consumes the same way: the backward passes the cotangent
    through unchanged."""
    return _ReplicatedSum.apply(x, mesh, axis)


def broadcast(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Global rank ``src``'s ``x`` on every rank of the world, as a new tensor."""
    w = _to_wire(x.detach(), None)
    if w.data_ptr() == x.data_ptr():
        w = w.clone()
    dist.broadcast(w, src=src)
    _count("broadcast", w)
    return _from_wire(w, x)


class MeshReducer:
    """The reductions of a training loop on ``mesh``: ``grads`` sums a
    replicated parameter's gradient over the ``state`` axis (each rank's
    autograd sees only its shard's share) and averages it over ``dp``;
    ``state_sum`` sums a per-shard partial (a TVD) over ``state``; the
    world's rank 0 is the one ``writer`` of files, and ``barrier`` orders
    its writes before every rank's reads."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.dp = axis_size(mesh, DATA_AXIS)
        self.states = axis_size(mesh, STATE_AXIS)
        self.writer = dist.get_rank() == 0

    def grads(self, g: torch.Tensor) -> torch.Tensor:
        if self.states > 1:
            g = all_reduce(g, self.mesh, STATE_AXIS)
        if self.dp > 1:
            g = all_reduce(g, self.mesh, DATA_AXIS) / self.dp
        return g

    def state_sum(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce(t, self.mesh, STATE_AXIS) if self.states > 1 else t

    def barrier(self) -> None:
        dist.barrier()
