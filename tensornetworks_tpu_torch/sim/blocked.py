"""Blocked statevector execution: the reference ansätze as block matmuls on
the flat (2^n,) state, the path past the circuit kernels' 24 qubits.

Counterpart of ``tensornetworks_tpu/sim/blocked.py``. A layer of an ansatz
becomes:

1. **Rotations**: consecutive qubits are grouped into blocks of ``b`` (8 by
   default, the remainder first); each block's per-qubit 2x2 rotations fold
   into one (2^b, 2^b) operator, applied as one matmul over the
   (pre, 2^b, post) view (``ops.kron.apply_adjacent_block``). Block 0's
   operator has the chain CNOTs inside block 0 composed in.
2. **CNOT chain**: the chain CNOTs inside each later block are one
   permutation matrix per block, each boundary CNOT a 4x4 adjacent-bit
   matmul, and the ring wrap CNOT(n-1, 0) is H₀·CZ(n-1, 0)·H₀.
3. **CZ layer**: a layer's CZ gates multiply into one ±1 sign vector.

The rotation operators of every layer are built in one batched pass
(``make_block_matrices_fn``), shared with the adjoint backward
(``sim/blocked_adjoint.py``), so both apply the same operator. Memory is
what sets n here, not a kernel: the circuit kernels' dense (L, R, R)
operators stop at 24 qubits and their gate path at 30, the 2^b-wide blocks
do not. The sign vectors
are built on the state's device from an index range once per executor and
kept (one 2^n real vector per distinct CZ pattern).

``conditioning=True`` adds the conditioning wall: RY(angles[q]) on every
qubit after the Hadamard wall, one block operator per block, and the
executor takes ``(params, embed_angles)``. It is the reference-ansatz
oracle of the conditioned circuit kernels and the executor of conditioned
machines past the circuit kernels' range.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..train import span
from .gates import _layer_rotations, kron_fold, ry_batched

# The ansätze whose entanglers are fixed by n and the layer: built gate for
# gate in ``sim.ansatz`` and by the blocked executors here.
FIXED_ANSATZ_TYPES = ("hardware_efficient", "all_to_all", "basic")


def _cnot_map(idx: np.ndarray, n: int, c: int, t: int) -> np.ndarray:
    """Forward basis-state map of CNOT(control=c, target=t) on MSB-first ints."""
    cb = 1 << (n - 1 - c)
    tb = 1 << (n - 1 - t)
    return idx ^ (((idx & cb) >> (n - 1 - c)) * tb)


def _chain_gates(n: int, ansatz_type: str) -> List[Tuple[int, int]]:
    """The entangling CNOT sequence of one layer: nearest-neighbour chain and
    the ring wrap CNOT(n-1, 0) when n > 2."""
    gates = []
    if n > 1:
        for q in range(n - 1):
            gates.append((q, q + 1))
        if n > 2:
            gates.append((n - 1, 0))
    return gates


def _cz_pairs(n: int, layer: int, ansatz_type: str) -> List[Tuple[int, int]]:
    """CZ gates of one layer: skip links on even hardware_efficient layers,
    all pairs for all_to_all."""
    if ansatz_type == "hardware_efficient":
        if layer % 2 == 0 and n > 2:
            return [(q, q + 2) for q in range(0, n - 2, 2)]
        return []
    if ansatz_type == "all_to_all":
        return [(a, b) for a in range(n) for b in range(a + 1, n)] if n > 1 else []
    return []


def _blocks(n: int, b: int) -> List[Tuple[int, int]]:
    """Consecutive (start, size) qubit blocks covering [0, n), the
    remainder block first."""
    r = n % b
    out = [(0, r)] if r else []
    out += [(s, b) for s in range(r, n, b)]
    return out


def _chain_permutation(n: int, ansatz_type: str) -> Optional[np.ndarray]:
    """Inverse index permutation of a layer's whole CNOT chain,
    ``state_out = state_in[perm]`` (a test reference; the executor uses the
    block decomposition)."""
    gates = _chain_gates(n, ansatz_type)
    if not gates:
        return None
    idx = np.arange(1 << n, dtype=np.int64)
    fwd = idx.copy()
    for c, t in gates:
        fwd = _cnot_map(idx, n, c, t)[fwd]
    inv = np.empty(1 << n, dtype=np.int32)
    inv[fwd] = idx.astype(np.int32)
    return inv


def _local_perm_matrix(gates: List[Tuple[int, int]], start: int,
                       bsize: int) -> Optional[np.ndarray]:
    """(2^b, 2^b) permutation matrix of the chain CNOTs lying inside the
    block [start, start+b), applied in order; None if there are none."""
    local = [(c - start, t - start) for c, t in gates
             if start <= c < start + bsize and start <= t < start + bsize]
    if not local:
        return None
    idx = np.arange(1 << bsize, dtype=np.int64)
    fwd = idx.copy()
    for c, t in local:
        fwd = _cnot_map(idx, bsize, c, t)[fwd]
    P = np.zeros((1 << bsize, 1 << bsize), dtype=np.complex128)
    P[fwd, idx] = 1.0
    return P


def _cz_diag(n: int, pairs: List[Tuple[int, int]]) -> Optional[np.ndarray]:
    """The ±1 sign vector of a set of CZ gates on the host (None if none)."""
    if not pairs:
        return None
    idx = np.arange(1 << n, dtype=np.int64)
    sign = np.ones(1 << n, dtype=np.float32)
    for a, b in pairs:
        ab = ((idx >> (n - 1 - a)) & 1) & ((idx >> (n - 1 - b)) & 1)
        sign *= 1.0 - 2.0 * ab.astype(np.float32)
    return sign


def _cz_diag_device(n: int, pairs: List[Tuple[int, int]], dtype=torch.float32,
                    device="cuda") -> torch.Tensor:
    """The same sign vector computed on ``device`` from an index range."""
    idx = torch.arange(1 << n, dtype=torch.int32, device=device)
    sign = torch.ones(1 << n, dtype=dtype, device=device)
    for a, b in pairs:
        ab = ((idx >> (n - 1 - a)) & 1) * ((idx >> (n - 1 - b)) & 1)
        sign *= 1.0 - 2.0 * ab.to(dtype)
    return sign


_CNOT4 = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
                  dtype=np.complex128)
_H2 = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2.0)


def _hadamard_block(size: int) -> np.ndarray:
    """H^{⊗size} as a dense (2^size, 2^size) matrix."""
    M = np.eye(1, dtype=np.complex128)
    for _ in range(size):
        M = np.kron(M, _H2)
    return M


def _check_ansatz(ansatz_type: str):
    if ansatz_type not in FIXED_ANSATZ_TYPES:
        raise ValueError(f"the blocked executor builds {FIXED_ANSATZ_TYPES}, "
                         f"got {ansatz_type!r}")


def make_block_matrices_fn(num_wires: int, layers: int, ansatz_type: str, block: int = 8,
                           dtype=torch.complex64):
    """params -> list of per-block ``(layers, 2^b, 2^b)`` rotation operators,
    block 0's intra-block chain permutation composed in. Shared by the
    forward executor and the adjoint backward."""
    _check_ansatz(ansatz_type)
    n = num_wires
    blocks = _blocks(n, block)
    per_qubit = 3 if ansatz_type in ("hardware_efficient", "all_to_all") else 2
    chain = _chain_gates(n, ansatz_type) if ansatz_type in ("hardware_efficient", "basic") else []
    perm0 = _local_perm_matrix(chain, *blocks[0]) if chain else None

    def block_matrices(params: torch.Tensor) -> List[torch.Tensor]:
        with span("born.fold"):
            U = _layer_rotations(params, n, layers, per_qubit).to(dtype)  # (layers, n, 2, 2)
            out = []
            for i, (s, bs) in enumerate(blocks):
                M = kron_fold([U[:, q] for q in range(s, s + bs)])
                if i == 0 and perm0 is not None:
                    M = torch.as_tensor(perm0, dtype=dtype, device=M.device) @ M
                out.append(M)
            return out

    return block_matrices


class _Entanglers:
    """The static part of a blocked layer (block plan, chain permutations,
    boundary CNOTs, ring wrap, CZ pairs) with the device constants it needs,
    each made once per (dtype, device)."""

    def __init__(self, n: int, layers: int, ansatz_type: str, block: int):
        self.n = n
        self.blocks = _blocks(n, block)
        self.chain = (_chain_gates(n, ansatz_type)
                      if ansatz_type in ("hardware_efficient", "basic") else [])
        self.perms = ([_local_perm_matrix(self.chain, s, bs) for s, bs in self.blocks]
                      if self.chain else [])
        self.boundaries = [(s - 1, s) for s, _ in self.blocks[1:]]
        self.ring_cross = bool(self.chain) and n > 2 and len(self.blocks) > 1
        self.cz = [tuple(_cz_pairs(n, layer, ansatz_type)) for layer in range(layers)]
        self.h_blocks = ([_hadamard_block(bs) for _, bs in self.blocks]
                         if ansatz_type in ("hardware_efficient", "all_to_all") else None)
        self._consts: Dict[tuple, torch.Tensor] = {}
        # Imported here, not with the module: ops.kernels imports this
        # module's CNOT helpers while the ops package initialises.
        from ..ops.kron import apply_adjacent_block
        self.apply_block = apply_adjacent_block

    def const(self, key, like: torch.Tensor) -> torch.Tensor:
        """A cached device constant: ("mat", name, i) for a small complex
        matrix, ("sign", pairs) for a CZ sign vector in the real dtype."""
        full = key + (like.dtype, like.device)
        if full not in self._consts:
            if key[0] == "sign":
                real = torch.empty((), dtype=like.dtype).real.dtype
                val = _cz_diag_device(self.n, list(key[1]), real, like.device)
            else:
                _, name, i = key
                host = {"h": lambda: self.h_blocks[i], "perm": lambda: self.perms[i],
                        "perm_t": lambda: self.perms[i].T, "cnot4": lambda: _CNOT4,
                        "h2": lambda: _H2}[name]()
                val = torch.as_tensor(np.ascontiguousarray(host), dtype=like.dtype,
                                      device=like.device)
            self._consts[full] = val
        return self._consts[full]

    def apply(self, state, name, i, start, size):
        return self.apply_block(state, self.const(("mat", name, i), state), start, size, self.n)

    def ring_wrap(self, state):
        """CNOT(n-1, 0) as H₀·CZ(n-1, 0)·H₀ (an involution)."""
        state = self.apply(state, "h2", 0, 0, 1)
        state = state * self.const(("sign", ((self.n - 1, 0),)), state)
        return self.apply(state, "h2", 0, 0, 1)

    def forward_tail(self, state, layer):
        """A layer's entanglers after its rotations: boundary CNOTs and the
        later blocks' chain permutations, the ring wrap, the CZ signs."""
        if self.chain:
            for i in range(1, len(self.blocks)):
                state = self.apply(state, "cnot4", 0, self.boundaries[i - 1][0], 2)
                if self.perms[i] is not None:
                    state = self.apply(state, "perm", i, *self.blocks[i])
        if self.ring_cross:
            state = self.ring_wrap(state)
        if self.cz[layer]:
            state = state * self.const(("sign", self.cz[layer]), state)
        return state


def make_blocked_state_fn(num_wires: int, layers: int, ansatz_type: str, block: int = 8,
                          dtype=torch.complex64, remat_layers: bool = False,
                          conditioning: bool = False):
    """``state(params)``: the flat (2^n,) state of the ansatz by blocked
    execution, on ``params``' device; ``state(params, embed_angles)`` with
    ``conditioning`` (the (n,) RY wall after the Hadamard wall).
    ``remat_layers`` wraps each layer in ``torch.utils.checkpoint``, so that
    autograd keeps the L layer-boundary states and recomputes the rest in
    the backward."""
    _check_ansatz(ansatz_type)
    n = num_wires
    ent = _Entanglers(n, layers, ansatz_type, block)
    block_matrices = make_block_matrices_fn(num_wires, layers, ansatz_type, block, dtype)

    def layer_body(layer, state, *layer_mats):
        for M, (s, bs) in zip(layer_mats, ent.blocks):
            state = ent.apply_block(state, M, s, bs, n)
        return ent.forward_tail(state, layer)

    def state_fn(params: torch.Tensor, embed_angles=None) -> torch.Tensor:
        state = torch.zeros(1 << n, dtype=dtype, device=params.device)
        state[0] = 1.0
        if ent.h_blocks is not None:
            for i, (s, bs) in enumerate(ent.blocks):
                state = ent.apply(state, "h", i, s, bs)
        if conditioning:
            if embed_angles is None:
                raise ValueError("conditioning=True requires embed_angles")
            E = ry_batched(embed_angles.reshape(n)).to(dtype)  # (n, 2, 2)
            for s, bs in ent.blocks:
                state = ent.apply_block(state, kron_fold([E[q] for q in range(s, s + bs)]),
                                        s, bs, n)
        mats = block_matrices(params)
        for layer in range(layers):
            layer_mats = [m[layer] for m in mats]
            if remat_layers and torch.is_grad_enabled():
                state = checkpoint(layer_body, layer, state, *layer_mats, use_reentrant=False)
            else:
                state = layer_body(layer, state, *layer_mats)
        return state

    state_fn.entanglers = ent
    return state_fn


def make_blocked_probs_fn(num_wires: int, layers: int, ansatz_type: str, block: int = 8,
                          dtype=torch.complex64, remat_layers: bool = False,
                          conditioning: bool = False):
    """``probs(params[, embed_angles])`` = |state|² of
    :func:`make_blocked_state_fn`, differentiable by autograd."""
    state_fn = make_blocked_state_fn(num_wires, layers, ansatz_type, block, dtype,
                                     remat_layers=remat_layers, conditioning=conditioning)

    def probs_fn(params: torch.Tensor, embed_angles=None) -> torch.Tensor:
        with span("circuit.forward"):
            amp = state_fn(params, embed_angles)
            return amp.real ** 2 + amp.imag ** 2

    return probs_fn
