"""2D super-block statevector execution: the state as a fixed-shape matrix.

Counterpart of ``tensornetworks_tpu/sim/blocked2d.py``, and the plain
version of the circuit kernel (``ops/kernels/circuit2d.py``): the same
circuit written with dense matmuls and ±1 masks, differentiated by torch
autograd.

The state reshapes to ``X ∈ C^(R×C)`` with ``R = 2^ceil(n/2)`` (qubits
0..rb-1 on rows) and ``C = 2^floor(n/2)``. Row operators act as
``X ← M X``, column operators as ``X ← X Mᵀ``; the boundary and ring CNOTs
are ``H_t · CZ · H_t``; a layer's CZ gates are one ±1 mask.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .ansatz import FIXED_ANSATZ_TYPES
from .blocked import _chain_gates, _cnot_map, _cz_pairs
from .gates import rotation_operators

MAX_2D_QUBITS = 18


def _perm_matrix(gates: List[Tuple[int, int]], nbits: int) -> Optional[np.ndarray]:
    """Permutation matrix for CNOTs (local wire indices) applied in order."""
    if not gates:
        return None
    size = 1 << nbits
    idx = np.arange(size, dtype=np.int64)
    fwd = idx.copy()
    for c, t in gates:
        fwd = _cnot_map(idx, nbits, c, t)[fwd]
    P = np.zeros((size, size), dtype=np.complex128)
    P[fwd, idx] = 1.0
    return P


def _kron_h(nbits: int, wire: int) -> np.ndarray:
    """I ⊗ ... ⊗ H(at wire) ⊗ ... ⊗ I over nbits wires."""
    H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2.0)
    M = np.eye(1, dtype=np.complex128)
    for w in range(nbits):
        M = np.kron(M, H if w == wire else np.eye(2, dtype=np.complex128))
    return M


def _h_wall(nbits: int) -> np.ndarray:
    H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2.0)
    M = np.eye(1, dtype=np.complex128)
    for _ in range(nbits):
        M = np.kron(M, H)
    return M


def _cz_sign_mask(rb: int, cb: int, pairs: List[Tuple[int, int]]) -> Optional[np.ndarray]:
    """(R, C) ±1 mask for a set of CZ gates."""
    if not pairs:
        return None
    r = np.arange(1 << rb)[:, None]
    c = np.arange(1 << cb)[None, :]

    def bit(q):
        return (r >> (rb - 1 - q)) & 1 if q < rb else (c >> (cb - 1 - (q - rb))) & 1

    sign = np.ones((1 << rb, 1 << cb))
    for a, b in pairs:
        sign = sign * (1.0 - 2.0 * (bit(a) * bit(b)))
    return sign


class Blocked2dCircuit:
    """The circuit in the (R, C) matmul formulation: ``state(Mr, Mc)`` runs
    the layers on given per-layer operators, ``probs(params)`` builds them
    from θ first."""

    def __init__(self, num_wires: int, layers: int, ansatz_type: str):
        if ansatz_type not in FIXED_ANSATZ_TYPES:
            raise ValueError(f"blocked2d builds {FIXED_ANSATZ_TYPES}, got {ansatz_type!r}")
        n = num_wires
        if n < 2 or n > MAX_2D_QUBITS:
            raise ValueError(f"blocked2d supports 2 <= n <= {MAX_2D_QUBITS}, got {n}")
        rb = (n + 1) // 2
        cb = n - rb
        self.n, self.layers, self.R, self.C = n, layers, 1 << rb, 1 << cb
        self.per_qubit = 3 if ansatz_type in ("hardware_efficient", "all_to_all") else 2
        self.has_chain = ansatz_type in ("hardware_efficient", "basic")
        chain = _chain_gates(n, ansatz_type) if self.has_chain else []
        row_chain = [(c, t) for c, t in chain if c < rb and t < rb]
        col_chain = [(c - rb, t - rb) for c, t in chain if c >= rb and t >= rb]
        self.boundary = [(c, t) for c, t in chain
                         if (c < rb) != (t < rb) and not (c == n - 1 and t == 0)]
        self.ring = bool(chain) and n > 2
        self.has_wall = ansatz_type in ("hardware_efficient", "all_to_all")
        self.static = {
            "P_row": _perm_matrix(row_chain, rb),
            "P_col": _perm_matrix(col_chain, cb),
            "H_wall_row": _h_wall(rb) if self.has_wall else None,
            "H_wall_col": _h_wall(cb) if self.has_wall else None,
            "H_col0": _kron_h(cb, 0),  # boundary CNOT(rb-1, rb): H on the target
            "H_row0": _kron_h(rb, 0),  # ring CNOT(n-1, 0): H on the target
            "bmask": _cz_sign_mask(rb, cb, self.boundary),
            "rmask": _cz_sign_mask(rb, cb, [(n - 1, 0)]),
        }
        self.cz_masks = [_cz_sign_mask(rb, cb, _cz_pairs(n, layer, ansatz_type))
                         for layer in range(layers)]

    def state(self, Mr: torch.Tensor, Mc: torch.Tensor) -> torch.Tensor:
        """The final (R, C) state for per-layer operators Mr, Mc."""
        dtype, dev = Mr.dtype, Mr.device

        def T(a):
            return None if a is None else torch.as_tensor(a, device=dev).to(dtype)

        t = {k: T(v) for k, v in self.static.items()}
        X = torch.zeros((self.R, self.C), dtype=dtype, device=dev)
        X[0, 0] = 1.0
        if self.has_wall:
            X = t["H_wall_row"] @ X @ t["H_wall_col"].T
        for layer in range(self.layers):
            M = Mr[layer] if t["P_row"] is None else t["P_row"] @ Mr[layer]
            X = M @ X @ Mc[layer].T
            if self.has_chain:
                if self.boundary:
                    X = (X @ t["H_col0"]) * t["bmask"]
                    X = X @ t["H_col0"]
                if t["P_col"] is not None:
                    X = X @ t["P_col"].T
                if self.ring:
                    X = t["rmask"] * (t["H_row0"] @ X)
                    X = t["H_row0"] @ X
            if self.cz_masks[layer] is not None:
                X = X * T(self.cz_masks[layer])
        return X

    def probs(self, params: torch.Tensor) -> torch.Tensor:
        X = self.state(*rotation_operators(params, self.n, self.layers, self.per_qubit))
        return (X.real**2 + X.imag**2).reshape(-1)


def make_blocked2d_probs_fn(num_wires: int, layers: int, ansatz_type: str):
    """probs(params) -> (2^n,) through the (R, C) matmul formulation."""
    return Blocked2dCircuit(num_wires, layers, ansatz_type).probs
