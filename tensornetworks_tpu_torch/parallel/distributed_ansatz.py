"""Whole circuits on a state-sharded register, gate by gate.

Counterpart of ``tensornetworks_tpu/parallel/distributed_ansatz.py``: the
primitive program of an ansatz (``sim.adjoint.primitive_ansatz_program``:
the Hadamard wall, one rotation per parameter, the CNOTs and CZs of
hardware_efficient, basic, all_to_all or bn_structured with ``edges``) runs
gate by gate on this rank's (2^n/D,) shard through ``shard_state``: partner
exchanges for gates on global bits, no communication for diagonal gates or
local bits. State memory is 2^n/D per rank.

Plain torch, as the JAX module is plain XLA: a shard cannot run the circuit
kernels, whose layers hold whole 2^n states, since gates on global bits come
between the local ones. Autograd keeps one state per gate for the backward.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..sim.adjoint import primitive_ansatz_program
from ..sim.gates import H, rx_batched, ry_batched, rz_batched
from .mesh import STATE_AXIS, axis_index, axis_size
from .shard_state import distributed_apply_1q, distributed_apply_cnot, distributed_apply_cz

_ROT = {"x": rx_batched, "y": ry_batched, "z": rz_batched}


def make_distributed_ansatz_probs(mesh: DeviceMesh, num_wires: int, layers: int,
                                  ansatz_type: str, dtype=torch.complex64, edges=None,
                                  conditioning: bool = False):
    """``probs(params[, embed_angles])``: this rank's (2^n/D,) shard of the
    circuit's |ψ|², differentiable in ``params``. ``ansatz_type=
    'bn_structured'`` takes ``edges``; ``conditioning=True`` adds an
    RY(embed_angles[q]) wall between the Hadamard wall and the first
    rotation (the angle-embedding conditioning), and the function then
    takes the angles as its second argument."""
    program = primitive_ansatz_program(num_wires, layers, ansatz_type, edges=edges)
    if conditioning and not any(op[0] == "r" for op in program):
        raise ValueError("conditioning requires a parameterized ansatz")
    apply_1q = distributed_apply_1q(mesh, num_wires)
    apply_cnot = distributed_apply_cnot(mesh, num_wires)
    apply_cz = distributed_apply_cz(mesh, num_wires)
    local_size = (1 << num_wires) // axis_size(mesh, STATE_AXIS)
    first_shard = axis_index(mesh, STATE_AXIS) == 0
    # The parameter index of each rotation, by axis, in program order: the
    # rotations of one axis are built in one batched call per forward.
    rot_idx = {axis: [op[3] for op in program if op[0] == "r" and op[2] == axis]
               for axis in _ROT}

    def run(params: torch.Tensor, embed_angles=None) -> torch.Tensor:
        state = torch.zeros(local_size, dtype=dtype, device=params.device)
        if first_shard:
            state[0] = 1.0
        h_mat = torch.as_tensor(H, dtype=dtype, device=params.device)
        mats = {axis: iter(_ROT[axis](params[torch.tensor(ix, device=params.device)]).unbind(0))
                for axis, ix in rot_idx.items() if ix}
        wall_pending = conditioning
        for op in program:
            if op[0] == "h":
                state = apply_1q(state, h_mat, op[1])
            elif op[0] == "r":
                if wall_pending:
                    walls = ry_batched(torch.as_tensor(embed_angles, device=params.device))
                    for q in range(num_wires):
                        state = apply_1q(state, walls[q], q)
                    wall_pending = False
                state = apply_1q(state, next(mats[op[2]]), op[1])
            elif op[0] == "cnot":
                state = apply_cnot(state, op[1], op[2])
            else:
                state = apply_cz(state, op[1], op[2])
        return state.real ** 2 + state.imag ** 2

    if conditioning:
        return run
    return lambda params: run(params)
