"""Gate work of the benchmark's circuits on a 2^n statevector.

- A fused single-qubit rotation (RZ.RY.RX of one qubit in one layer) is a
  2x2 complex matrix on every amplitude pair: 4 complex multiplications
  (6 FLOPs each) and 2 complex additions (2 each) per pair, 14 FLOPs per
  amplitude.
- CNOT and CZ are permutations and sign flips, and the starting Hadamard
  wall is the uniform state: no FLOPs.
- The forward ends in |psi|^2: 3 FLOPs per amplitude.
- The adjoint backward forms the cotangent g * psi (2 FLOPs per
  amplitude), un-computes every rotation and carries the cotangent back
  through it (twice the forward's rotations), and takes one inner product
  per parameter (the real part of <lambda, dU psi>: 4 FLOPs per amplitude).
- Bytes: the forward reads the angles and writes q (4-byte floats), the
  backward reads dL/dq and writes the angles' gradient.
"""

from __future__ import annotations

ROTATION_FLOPS = 14   # per amplitude, one fused 2x2 gate
PROBS_FLOPS = 3       # per amplitude, |psi|^2
COTANGENT_FLOPS = 2   # per amplitude, g * psi
INNER_FLOPS = 4       # per amplitude, Re <a, b>
WORD = 4              # bytes of a float32

PER_QUBIT = {"hardware_efficient": 3, "bn_structured": 3, "all_to_all": 3, "basic": 2}


def num_params(ansatz: str, n: int, layers: int) -> int:
    return PER_QUBIT[ansatz] * n * layers


def forward(ansatz: str, n: int, layers: int) -> dict:
    size = 1 << n
    gates = n * layers
    return {"flops": float(gates * ROTATION_FLOPS * size + PROBS_FLOPS * size),
            "bytes": float(WORD * (num_params(ansatz, n, layers) + size))}


def backward(ansatz: str, n: int, layers: int) -> dict:
    size = 1 << n
    gates = n * layers
    flops = (COTANGENT_FLOPS * size + 2 * gates * ROTATION_FLOPS * size
             + num_params(ansatz, n, layers) * INNER_FLOPS * size)
    return {"flops": float(flops),
            "bytes": float(WORD * (size + num_params(ansatz, n, layers)))}
