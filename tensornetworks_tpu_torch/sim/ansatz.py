"""PQC ansätze gate for gate: the small-n oracle and the ``einsum`` backend.

Counterpart of ``tensornetworks_tpu/sim/ansatz.py``:
- ``hardware_efficient``: Hadamard wall; per layer RX,RY,RZ on every qubit,
  nearest-neighbour CNOT chain, ring CNOT(n-1, 0) when n > 2, CZ(i, i+2)
  skip links on even layers when n > 2. 3·L·n params.
- ``all_to_all``: Hadamard wall; per layer RX,RY,RZ per qubit and CZ on all
  pairs. 3·L·n params.
- ``basic``: per layer RY,RZ per qubit, CNOT chain, ring wrap when n > 2.
  2·L·n params (no Hadamard wall).
- ``bn_structured``: the HE layer's rotations, entanglers from a Bayesian
  network's edges; 3·L·n params. It is built in ``sim/structured.py``, not
  gate for gate here.

Parameters are laid out (layer, qubit, angle); the per-qubit rotations are
fused into one 2x2 unitary before application.
"""

from __future__ import annotations

import torch

from .blocked import FIXED_ANSATZ_TYPES, _chain_gates, _cz_pairs
from .gates import layer_rotations
from .statevector import (apply_cnot, apply_cz, apply_gate, hadamard_wall, probabilities,
                          zero_state)

ANSATZ_TYPES = FIXED_ANSATZ_TYPES + ("bn_structured",)


def num_ansatz_params(num_wires: int, layers: int, ansatz_type: str) -> int:
    if ansatz_type in ("hardware_efficient", "all_to_all", "bn_structured"):
        return layers * 3 * num_wires
    if ansatz_type == "basic":
        return layers * 2 * num_wires
    raise ValueError(f"Unknown ansatz_type {ansatz_type!r}; expected one of {ANSATZ_TYPES}")


def ansatz_state(params: torch.Tensor, num_wires: int, layers: int,
                 ansatz_type: str) -> torch.Tensor:
    """ψ(θ) as a (2,)*n complex tensor."""
    if ansatz_type not in FIXED_ANSATZ_TYPES:
        raise ValueError(f"ansatz_state builds {FIXED_ANSATZ_TYPES}, got {ansatz_type!r} "
                         "(bn_structured: sim.structured.make_structured_probs_fn)")
    n = num_wires
    per_qubit = 2 if ansatz_type == "basic" else 3
    U = layer_rotations(params, n, layers, per_qubit)
    state = zero_state(n, dtype=U.dtype, device=params.device)
    if ansatz_type != "basic":
        state = hadamard_wall(state)
    for layer in range(layers):
        for q in range(n):
            state = apply_gate(state, U[layer, q], [q])
        if n > 1 and ansatz_type != "all_to_all":
            for c, t in _chain_gates(n, ansatz_type):
                state = apply_cnot(state, c, t)
        for a, b in _cz_pairs(n, layer, ansatz_type):
            state = apply_cz(state, a, b)
    return state


def ansatz_probs(params: torch.Tensor, num_wires: int, layers: int,
                 ansatz_type: str) -> torch.Tensor:
    """Full analytic distribution |⟨z|ψ(θ)⟩|² over all 2^n outcomes."""
    return probabilities(ansatz_state(params, num_wires, layers, ansatz_type))
