"""The gate path's CUDA kernels (``csrc/circuit_gates.cu``, kernels 5-6
under the kernel precision ``highest``) on the card: against their plain
version on the same card (FP32, the kernels' tiles and gate order), against
float64, against the FP32 dense-operator kernels of
``csrc/circuit2d_grid.cu`` on the same θ (probabilities and dθ through each
path's fold), bit for bit over two runs, and the launch counters of an
exact and a sampled epoch.

These tests need a CUDA card and skip without one. On the card, without
the JAX package (the tests' conftest imports it):
``python -m pytest tests/test_torch_circuit_gates_chip.py -m chip --noconftest -q``.

Tolerances, relative to the largest magnitude of the float64 result: the
gate path rounds once per gate and amplitude (24 gates a layer at n = 24,
each four products summed), about L·n·2^-24 ≈ 1e-5 at bn L = 8 after the
errors' growth through |ψ|² and the adjoint; the dense path sums 4096-long
products. The forward is held to 2e-5 and dθ to 2e-4, the grid kernels'
own margins (chip_smoke.py ``TOL``)."""

import numpy as np
import pytest
import torch

from tensornetworks_tpu_torch.ops.kernels import _lib
from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg
from tensornetworks_tpu_torch.sim.gates import layer_rotations

pytestmark = pytest.mark.chip

HE, BN = "hardware_efficient", "bn_structured"
CASES = [(18, HE, 4), (20, HE, 4), (24, HE, 4), (18, BN, 8), (20, BN, 8), (24, BN, 8)]
TOL_FWD, TOL_BWD = 2e-5, 2e-4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _edges(n, seed=7):
    """A random DAG of parents before children, at most two parents each."""
    rng = np.random.default_rng(seed)
    return [(int(p), c) for c in range(1, n)
            for p in rng.choice(c, size=min(c, int(rng.integers(0, 3))), replace=False)]


def _rel(a, b):
    b = b.double()
    return float((a.double() - b).abs().max() / b.abs().max())


def _theta(plan, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0, 2 * np.pi, plan.per_qubit * plan.n * plan.layers))


@pytest.mark.parametrize("n,ansatz,L", CASES)
def test_gate_kernels_against_plain_float64_and_dense(n, ansatz, L, cuda):
    plan = kg.GridPlan(n, L, ansatz, _edges(n) if ansatz == BN else None, precision="highest")
    th = _theta(plan, n + L).to(cuda, torch.float32)
    g = torch.as_tensor(np.random.default_rng(3).normal(size=(plan.R, plan.C)),
                        dtype=torch.float32, device=cuda)
    U = layer_rotations(th, n, L, plan.per_qubit)
    probs, xr, xi = kg.circuit_gates_forward(U, plan)
    again = kg.circuit_gates_forward(U, plan)
    assert all(torch.equal(a, b) for a, b in zip((probs, xr, xi), again))
    dU = kg.circuit_gates_backward(U, xr, xi, g, plan)
    assert torch.equal(dU, kg.circuit_gates_backward(U, xr, xi, g, plan))

    plain = kg.circuit_gates_forward_plain(U, plan)
    f64 = kg.circuit_gates_forward_plain(U.to(torch.complex128), plan)
    err = {"fwd plain": _rel(probs, plain[0]), "fwd f64": _rel(probs, f64[0])}
    dU_plain = kg.circuit_gates_backward_plain(U, plain[1], plain[2], g, plan)
    dU_f64 = kg.circuit_gates_backward_plain(U.to(torch.complex128), f64[1], f64[2],
                                             g.double(), plan)
    err |= {"dU plain": _rel(torch.view_as_real(dU), torch.view_as_real(dU_plain)),
            "dU f64": _rel(torch.view_as_real(dU), torch.view_as_real(dU_f64))}

    # dθ through each path's fold, on the same θ and cotangent.
    def dtheta(path):
        t = th.clone().requires_grad_(True)
        if path == "gates":
            q = kg.CircuitGatesFunction.apply(layer_rotations(t, n, L, plan.per_qubit), plan)
        else:
            q = kg.Circuit2dGridFunction.apply(*kg.grid_operators(t, plan), plan)
        (q * g).sum().backward()
        return q.detach(), t.grad

    q_gates, d_gates = dtheta("gates")
    q_dense, d_dense = dtheta("dense")
    t64 = th.double().requires_grad_(True)
    U64 = layer_rotations(t64, n, L, plan.per_qubit)
    d64, = torch.autograd.grad(U64, t64, grad_outputs=dU_f64)
    err |= {"fwd dense": _rel(q_gates, q_dense), "dtheta dense": _rel(d_gates, d_dense),
            "dtheta f64": _rel(d_gates, d64), "dense dtheta f64": _rel(d_dense, d64)}
    print(f"circuit_gates n={n} {ansatz} L={L}: " + ", ".join(f"{k} {v:.2e}"
                                                              for k, v in err.items()))
    for k, v in err.items():  # the dense path's own errors are printed, not held here
        if not k.startswith("dense"):
            assert v <= (TOL_FWD if k.startswith("fwd") else TOL_BWD), (k, v)


def test_launch_counters_of_an_exact_and_a_sampled_epoch(cuda):
    """The FP32 grid paths launch the gate kernels and not the dense ones."""
    from tensornetworks_tpu_torch.runners.scale import run_scale_experiment

    for objective, want in (("ksd", {"circuit_gates_fwd", "circuit_gates_bwd", "stein2d_grid",
                                     "stein_gcorr"}),
                            ("sampled-ksd", {"circuit_gates_fwd", "circuit_gates_bwd"})):
        _lib.reset_launches()
        run_scale_experiment(num_qubits=18, layers=2, num_epochs=2, objective=objective,
                             ansatz=BN if objective == "ksd" else HE, num_samples=64,
                             verbose=False, device=cuda)
        torch.cuda.synchronize()
        launched = {k for k, v in _lib.LAUNCHES.items() if v}
        assert launched == want, (objective, dict(_lib.LAUNCHES))
