"""Per-gate adjoint differentiation on the (2,)*n statevector: the port's
independent oracle for the blocked adjoint (``sim/blocked_adjoint.py``).

Counterpart of ``tensornetworks_tpu/sim/adjoint.py``. The circuit is an
unfused gate list (each rotation with its own generator); the backward
walks it in reverse, pulling ψ and λ = w∘ψ back through each inverse gate
and reading, for a rotation RG(θ) = exp(-iθG/2),

    ∂L/∂θ = 2·Re⟨λ| ∂U/∂θ |ψ_before⟩ = Im⟨λ| G |ψ_after⟩.

It shares no code with the blocked executor: its gates are applied one by
one with ``sim.statevector``, not folded into block operators.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .gates import H, X, Y, Z, rx_batched, ry_batched, rz_batched
from .statevector import apply_cnot, apply_cz, apply_gate, probabilities, zero_state

# Primitive gate program: ("h", q) | ("r", q, axis, param_idx) | ("cnot", c, t) | ("cz", a, b)
PrimProgram = List[Tuple]

_ROT = {"x": rx_batched, "y": ry_batched, "z": rz_batched}
_GEN = {"x": X, "y": Y, "z": Z}


def primitive_ansatz_program(num_wires: int, layers: int, ansatz_type: str,
                             edges=None) -> PrimProgram:
    """The unfused gate list of an ansatz; ``bn_structured`` takes
    ``edges`` and entangles CNOT(parent→child) on even layers, CZ on odd
    ones, in ``sim.structured``'s gate order."""
    n = num_wires
    prog: PrimProgram = []
    idx = 0

    def rotations(axes):
        nonlocal idx
        for q in range(n):
            for axis in axes:
                prog.append(("r", q, axis, idx))
                idx += 1

    if ansatz_type == "bn_structured":
        if edges is None:
            raise ValueError("bn_structured requires edges")
        prog += [("h", q) for q in range(n)]
        for layer in range(layers):
            rotations("xyz")
            gate = "cnot" if layer % 2 == 0 else "cz"
            prog += [(gate, int(c), int(t)) for c, t in edges]
        return prog
    if ansatz_type in ("hardware_efficient", "all_to_all"):
        prog += [("h", q) for q in range(n)]
    for layer in range(layers):
        rotations("yz" if ansatz_type == "basic" else "xyz")
        if n <= 1:
            continue
        if ansatz_type == "all_to_all":
            prog += [("cz", a, b) for a in range(n) for b in range(a + 1, n)]
            continue
        prog += [("cnot", q, q + 1) for q in range(n - 1)]
        if n > 2:
            prog.append(("cnot", n - 1, 0))
        if ansatz_type == "hardware_efficient" and layer % 2 == 0 and n > 2:
            prog += [("cz", q, q + 2) for q in range(0, n - 2, 2)]
    return prog


def _forward_state(program: PrimProgram, params: torch.Tensor, num_wires: int, dtype):
    state = zero_state(num_wires, dtype=dtype, device=params.device)
    for op in program:
        if op[0] == "h":
            state = apply_gate(state, H, [op[1]])
        elif op[0] == "r":
            _, q, axis, idx = op
            state = apply_gate(state, _ROT[axis](params[idx]).to(dtype), [q])
        elif op[0] == "cnot":
            state = apply_cnot(state, op[1], op[2])
        else:
            state = apply_cz(state, op[1], op[2])
    return state


class _Adjoint(torch.autograd.Function):
    """probs = |ψ|² of a primitive program with the per-gate adjoint as its
    backward (module-level, as ``sim.blocked_adjoint``'s Function)."""

    @staticmethod
    def forward(ctx, params, program: PrimProgram, num_wires: int, dtype):
        state = _forward_state(program, params, num_wires, dtype)
        ctx.save_for_backward(params, state)
        ctx.program, ctx.dtype = program, dtype
        return probabilities(state)

    @staticmethod
    def backward(ctx, w):
        params, psi = ctx.saved_tensors
        dtype = ctx.dtype
        lam = w.reshape(psi.shape).to(psi.real.dtype) * psi  # λ = w ∘ ψ
        grads = torch.zeros_like(params)
        for op in reversed(ctx.program):
            if op[0] == "h":
                psi, lam = apply_gate(psi, H, [op[1]]), apply_gate(lam, H, [op[1]])  # H† = H
            elif op[0] == "r":
                _, q, axis, idx = op
                g_psi = apply_gate(psi, _GEN[axis], [q])
                grads[idx] += torch.vdot(lam.reshape(-1), g_psi.reshape(-1)).imag
                u_dag = _ROT[axis](-params[idx]).to(dtype)  # RG(θ)† = RG(-θ)
                psi, lam = apply_gate(psi, u_dag, [q]), apply_gate(lam, u_dag, [q])
            elif op[0] == "cnot":  # self-inverse
                psi, lam = apply_cnot(psi, op[1], op[2]), apply_cnot(lam, op[1], op[2])
            else:  # self-inverse
                psi, lam = apply_cz(psi, op[1], op[2]), apply_cz(lam, op[1], op[2])
        return grads, None, None, None


def make_adjoint_probs_fn(num_wires: int, layers: int, ansatz_type: str,
                          dtype=torch.complex64):
    """``probs(params)`` with the per-gate adjoint backward."""
    program = primitive_ansatz_program(num_wires, layers, ansatz_type)
    return lambda params: _Adjoint.apply(params, program, num_wires, dtype)
