"""SPMD statevector primitives on a register sharded over the leading bits.

Counterpart of ``tensornetworks_tpu/parallel/shard_state.py``. The (2^n,)
state is sharded over the mesh's ``state`` axis of D = 2^k ranks: rank i
holds the amplitudes whose leading k ("global") bits spell i, 2^(n-k) of
them in the order of the remaining ("local") bits. A gate on a local bit
needs no communication; a gate on a global bit pairs the ranks whose
indices differ in that bit, and the amplitude exchange is one
``comm.exchange`` (JAX's ``lax.ppermute``). Each function here is the
``shard_map`` body of its JAX counterpart, run on every rank on the local
shard; which global bits this rank holds is a host integer, so the
per-rank selections of the JAX bodies (``jnp.where`` on the axis index)
are Python branches here.

``distributed_kron_matvec`` applies ``A^{⊗n}`` (A = [[1, a], [a, 1]], the
Hamming base kernel): the local ``A^{⊗(n-k)}`` through the stein2d kernels
(``local_kron_apply``), then one all-gather and this rank's row of
Mk = A^{⊗k}, which mixes the global bits.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.kernels.stein2d import stein2d_apply, stein2d_apply_grid
from ..ops.kernels.stein_gcorr import flip_bit
from ..ops.kron import apply_adjacent_block, kron_power_np
from ..sim.statevector import apply_cnot, apply_cz
from .comm import all_gather, exchange
from .mesh import STATE_AXIS, axis_index, axis_size

# Kernel 3 (the cluster butterfly) takes 1-17 bits, kernel 4 (the two-pass
# grid butterfly) 18 and up (ops/kernels/stein2d.py).
CLUSTER_MAX_VARS = 17


def num_global_bits(mesh: DeviceMesh) -> int:
    """k with D = 2^k ranks on the state axis."""
    d = axis_size(mesh, STATE_AXIS)
    k = int(np.log2(d))
    if 2**k != d:
        raise ValueError(f"state axis size {d} must be a power of 2")
    return k


def _bit(idx: int, k: int, q: int) -> int:
    """Global bit q (most significant first) of state rank ``idx``."""
    return (idx >> (k - 1 - q)) & 1


def distributed_apply_1q(mesh: DeviceMesh, num_vars: int):
    """``apply(state, U, qubit) -> state`` on this rank's (2^(n-k),) shard.
    A global-bit gate takes the partner's shard by ``exchange``; a local one
    contracts in place."""
    k = num_global_bits(mesh)
    local_n = num_vars - k
    idx = axis_index(mesh, STATE_AXIS)

    def apply_fn(state, U, qubit: int):
        U = torch.as_tensor(U, dtype=state.dtype, device=state.device)
        if qubit >= k:
            return apply_adjacent_block(state, U, qubit - k, 1, local_n)
        other = exchange(state, mesh, 1 << (k - 1 - qubit))
        if _bit(idx, k, qubit) == 0:
            return U[0, 0] * state + U[0, 1] * other
        return U[1, 1] * state + U[1, 0] * other

    return apply_fn


def distributed_apply_cz(mesh: DeviceMesh, num_vars: int):
    """CZ between any two wires; diagonal, so no communication even on
    global bits: a global wire whose bit is 0 on this rank makes the gate
    the identity here, and a global 1 leaves a Z (or a sign) on the rest."""
    k = num_global_bits(mesh)
    local_n = num_vars - k
    idx = axis_index(mesh, STATE_AXIS)

    def apply_fn(state, q1: int, q2: int):
        wires = (q1, q2)
        if any(q < k and _bit(idx, k, q) == 0 for q in wires):
            return state
        local = [q - k for q in wires if q >= k]
        if not local:
            return -state
        if len(local) == 1:
            sign = torch.tensor([1.0, -1.0], dtype=state.dtype, device=state.device)
            return (state.reshape(1 << local[0], 2, -1) * sign[:, None]).reshape(state.shape)
        return apply_cz(state.reshape((2,) * local_n), *local).reshape(state.shape)

    return apply_fn


def distributed_apply_cnot(mesh: DeviceMesh, num_vars: int):
    """CNOT between any two wires, by where control c and target t live:

    - both local: the local CNOT, no communication;
    - c global, t local: the local target flip on the ranks whose c bit is 1;
    - t global: the partner's shard along t. With c global both partners
      hold the same c bit, so the pair exchanges only where it is 1 and
      takes the partner's shard whole; with c local each amplitude whose
      control bit is 1 takes the partner's."""
    k = num_global_bits(mesh)
    local_n = num_vars - k
    idx = axis_index(mesh, STATE_AXIS)

    def apply_fn(state, c: int, t: int):
        if c >= k and t >= k:
            return apply_cnot(state.reshape((2,) * local_n), c - k, t - k).reshape(state.shape)
        if t >= k:
            return flip_bit(state, t - k, local_n) if _bit(idx, k, c) else state
        if c < k:
            return exchange(state, mesh, 1 << (k - 1 - t)) if _bit(idx, k, c) else state
        other = exchange(state, mesh, 1 << (k - 1 - t))
        mine = state.reshape(1 << (c - k), 2, -1)
        theirs = other.reshape(1 << (c - k), 2, -1)
        return torch.stack([mine[:, 0], theirs[:, 1]], dim=1).reshape(state.shape)

    return apply_fn


def local_kron_apply(V: torch.Tensor, a: float, local_vars: int) -> torch.Tensor:
    """``A^{⊗m}`` (m = ``local_vars``) on every row of V (cols, 2^m), each
    row as an (R, C) block: kernel 3 up to 17 bits, kernel 4 from 18, their
    plain version on the CPU. m = 0 is the identity."""
    if local_vars == 0:
        return V
    rb = (local_vars + 1) // 2
    W = V.reshape(-1, 1 << rb, 1 << (local_vars - rb)).contiguous()
    apply = stein2d_apply if local_vars <= CLUSTER_MAX_VARS else stein2d_apply_grid
    return apply(a, W).reshape(V.shape)


def base_kernel_factor(A) -> float:
    """a of ``A = [[1, a], [a, 1]]``; raises for any other 2x2."""
    A = np.asarray(A, dtype=np.float64)
    a = float(A[0, 1])
    if A.shape != (2, 2) or A[0, 0] != 1.0 or A[1, 1] != 1.0 or A[1, 0] != a:
        raise ValueError(f"A must be [[1, a], [a, 1]], got {A.tolist()}")
    return a


def mix_global(gathered: torch.Tensor, Mk: np.ndarray, row: int) -> torch.Tensor:
    """``Σ_j Mk[row, j] · gathered[j]``: row ``row`` of the global-bit
    operator applied to the gathered (D, ...) shards."""
    w = torch.as_tensor(Mk[row], dtype=gathered.dtype, device=gathered.device)
    return torch.tensordot(w, gathered, dims=1)


def distributed_kron_matvec(mesh: DeviceMesh, A, num_vars: int, group: int = 7):
    """``matvec(v) = (A^{⊗n}) @ v`` on this rank's (2^(n-k),) shard of v:
    the local bits by ``local_kron_apply``, the k global bits by one
    all-gather and this rank's row of A^{⊗k} (dense over the global bits,
    so gather-then-contract). ``group`` is the JAX function's matmul block
    size; the butterfly kernels apply every local bit at once and take none."""
    del group
    a = base_kernel_factor(A)
    k = num_global_bits(mesh)
    Mk = kron_power_np(np.asarray(A, dtype=np.float64), k)
    local_vars = num_vars - k
    idx = axis_index(mesh, STATE_AXIS)

    def matvec(x):
        y = local_kron_apply(x[None], a, local_vars)
        return mix_global(all_gather(y, mesh), Mk, idx)[0]

    return matvec
