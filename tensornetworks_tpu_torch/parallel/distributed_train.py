"""Distributed KSD training: gradients through the state-sharded circuit and
the state-sharded Stein operator.

Counterpart of ``tensornetworks_tpu/parallel/distributed_train.py``. Every
2^n buffer (the statevector, q, the score table S and the n+1 Kronecker
columns) is sharded over the mesh's ``state`` axis, 2^n/D per rank. The
circuit exchanges partner shards for gates on global bits
(``distributed_ansatz``); the Stein quadratic form mixes the global bits
with one all-gather and a per-rank row of ``Mk = A^{⊗k}``; the scalar loss
is one all-reduce. The loss is ``sqrt(clamp(qᵀ K_p q, 1e-12))``, the
reference's (``ksd_vi.py:133-134``).

The matvec is the gcorr n+1-column form (``ops.stein.stein_matvec_gcorr``
derives it): only ``[q, S_t∘q]`` go through the Kronecker apply, locally
through kernel 3 or 4 (``shard_state.local_kron_apply``), then the
all-gather and the Mk mix; the 2n bit-masked columns are closed-form 2x2
corrections in plain torch, as the JAX function's are in XLA: for a local
bit an in-shard flip, for a global bit the partner rank's Mk row applied
to the same gathered buffer (no further collective).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.hamming import decay_factor
from ..ops.kernels.stein_gcorr import flip_bit
from ..ops.kron import kron_power_np
from .comm import MeshReducer, all_gather, all_reduce
from .distributed_ansatz import make_distributed_ansatz_probs
from .mesh import STATE_AXIS, axis_index, state_shard
from .shard_state import local_kron_apply, mix_global, num_global_bits


def make_distributed_stein_matvec(mesh: DeviceMesh, num_vars: int, length_scale: float = 1.0,
                                  group: int = 7):
    """``matvec(q, S) -> (K_p q)`` on this rank's shards: q (2^n/D,), S
    (2^n/D, n). ``group`` is the JAX function's matmul block size; the
    butterfly kernels take none."""
    del group
    k = num_global_bits(mesh)
    n = num_vars
    if k > n:
        raise ValueError(f"state axis ({1 << k} devices) exceeds 2^{n} states")
    a = decay_factor(n, length_scale)
    inv = 1.0 / (1.0 - a * a)
    aI = a * inv            # a/(1-a²): the constant flip weight
    G00 = -a * a * inv
    Mk = kron_power_np(np.array([[1.0, a], [a, 1.0]]), k)
    local_vars = n - k
    idx = axis_index(mesh, STATE_AXIS)

    def matvec(q, S):
        St = S.T
        V = local_kron_apply(torch.cat([q[None], St * q]), a, local_vars)  # (n+1, 2^n/D)
        gathered = all_gather(V, mesh)                                      # (D, n+1, 2^n/D)
        Y = mix_global(gathered, Mk, idx)
        P0, Q = Y[0], Y[1:]
        accS = torch.zeros_like(P0)   # Σ_t S_t ∘ flip_t(P0)
        accU = torch.zeros_like(P0)   # Σ_t flip_t(P0)
        accQ = torch.zeros_like(P0)   # Σ_t flip_t(Q_t)
        for t in range(n):
            if t < k:
                # global bit: the partner rank's values of [Kq, K(S_t q)]
                # are its Mk row applied to the same gathered buffer
                part = mix_global(gathered[:, [0, 1 + t]], Mk, idx ^ (1 << (k - 1 - t)))
                P0p, Qtp = part[0], part[1]
            else:
                P0p = flip_bit(P0, t - k, local_vars)
                Qtp = flip_bit(Q[t], t - k, local_vars)
            accS = accS + St[t] * P0p
            accU = accU + P0p
            accQ = accQ + Qtp
        R = St.sum(dim=0)
        c1 = 1.0 - 1.0 / a
        c2 = 1.0 - a
        term_G = (St * Q).sum(dim=0)
        y_Rj = Q.sum(dim=0)
        y_T1 = G00 * R * P0 + aI * accS
        y_T1t = G00 * y_Rj + aI * accQ
        y_Ri = R * P0
        y_D = (G00 * n) * P0 + aI * accU
        return (term_G
                - c1 * (y_T1 + y_T1t)
                - c2 * (y_Ri + y_Rj - y_T1 - y_T1t)
                + 2.0 * n * (1.0 - a) * P0
                - 2.0 * (1.0 / a - a) * y_D)

    return matvec


class _DistributedQuadForm(torch.autograd.Function):
    """qᵀ K_p q over the state shards: the local ``q·(K_p q)`` summed by one
    all-reduce. K_p is symmetric, so the gradient into this rank's q is
    ``2·g·(K_p q)`` on its shard: the forward matvec is reused and S gets
    none (a constant of the objective)."""

    @staticmethod
    def forward(ctx, q, S, matvec, mesh):
        y = matvec(q, S)
        ctx.save_for_backward(y)
        return all_reduce(torch.dot(q, y), mesh, STATE_AXIS)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return 2.0 * g * y, None, None, None


def make_distributed_stein_quadform(mesh: DeviceMesh, num_vars: int, length_scale: float = 1.0,
                                    group: int = 7):
    """``quadform(q, S) = qᵀ K_p q`` on state-sharded operands, the same
    value on every rank; the backward reuses the forward matvec (one
    distributed matvec an epoch)."""
    matvec = make_distributed_stein_matvec(mesh, num_vars, length_scale, group)
    return lambda q, S: _DistributedQuadForm.apply(q, S, matvec, mesh)


def place_stein_tables(mesh: DeviceMesh, score: np.ndarray, num_vars: int,
                       dtype=torch.float32, device="cuda"):
    """This rank's rows of the score table (2^n/D, n) on ``device``; a
    1-tuple, as the JAX function returns (the bits table cancelled out of
    the distributed matvec)."""
    del num_vars
    rows = state_shard(torch.from_numpy(np.asarray(score)), mesh)
    return (rows.to(device=device, dtype=dtype),)


def make_distributed_ksd_train_step(mesh: DeviceMesh, num_wires: int, layers: int,
                                    ansatz_type: str, optimizer, length_scale: float = 1.0,
                                    group: int = 7, state_dtype=torch.complex64,
                                    eps: float = 1e-12):
    """One distributed KSD step: sharded circuit → sharded Stein quadratic
    form → loss → gradient (through every collective, summed over the state
    shards and averaged over ``dp``) → ``optimizer`` (``engines.common``'s
    functional optimizer).

    Returns ``step(params, opt_state, S) -> (params, opt_state, loss)``
    with ``S`` from :func:`place_stein_tables`; ``params`` and the loss are
    the same on every rank."""
    probs_fn = make_distributed_ansatz_probs(mesh, num_wires, layers, ansatz_type,
                                             dtype=state_dtype)
    quadform = make_distributed_stein_quadform(mesh, num_wires, length_scale, group)
    reducer = MeshReducer(mesh)

    def step(params, opt_state, S):
        p = params.detach().requires_grad_(True)
        q = probs_fn(p).to(S.dtype)
        loss = torch.sqrt(torch.clamp(quadform(q, S), min=eps))
        (grads,) = torch.autograd.grad(loss, p)
        params, opt_state = optimizer.update(reducer.grads(grads), opt_state, params)
        return params, opt_state, loss.detach()

    return step
