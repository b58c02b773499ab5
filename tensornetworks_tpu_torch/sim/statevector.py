"""Statevector engine: states as (2,)*n complex tensors, gates as axis
contractions; gradients by torch autograd.

Counterpart of ``tensornetworks_tpu/sim/statevector.py``. Wire 0 is axis 0
(the most significant bit of the flat index).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .gates import H


def zero_state(num_wires: int, dtype=torch.complex64, device="cuda") -> torch.Tensor:
    """|0...0> as a (2,)*n tensor."""
    state = torch.zeros(2**num_wires, dtype=dtype, device=device)
    state[0] = 1.0
    return state.reshape((2,) * num_wires)


def apply_gate(state: torch.Tensor, U: torch.Tensor, wires: Sequence[int]) -> torch.Tensor:
    """Apply a k-wire operator U (2^k x 2^k) to the given wires."""
    wires = list(wires)
    k = len(wires)
    U_nd = torch.as_tensor(U, dtype=state.dtype, device=state.device).reshape((2,) * (2 * k))
    out = torch.tensordot(U_nd, state, dims=(list(range(k, 2 * k)), wires))
    return torch.movedim(out, list(range(k)), wires)


def apply_cz(state: torch.Tensor, w1: int, w2: int) -> torch.Tensor:
    """CZ via its diagonal [1, 1, 1, -1], broadcast over the other wires."""
    n = state.ndim
    diag = torch.tensor([[1.0, 1.0], [1.0, -1.0]], dtype=state.dtype, device=state.device)
    a, b = sorted((w1, w2))
    return state * diag.reshape([2 if i in (a, b) else 1 for i in range(n)])


def apply_cnot(state: torch.Tensor, control: int, target: int) -> torch.Tensor:
    """CNOT: flip the target axis within the control=1 slice (a permutation)."""
    off = state.select(control, 0)
    on = state.select(control, 1)
    on = torch.flip(on, dims=[target if target < control else target - 1])
    return torch.stack([off, on], dim=control)


def probabilities(state: torch.Tensor) -> torch.Tensor:
    """|ψ|² as a flat (2^n,) real vector."""
    amp = state.reshape(-1)
    return amp.real**2 + amp.imag**2


def hadamard_wall(state: torch.Tensor) -> torch.Tensor:
    """H on every wire."""
    for w in range(state.ndim):
        state = apply_gate(state, H, [w])
    return state
