"""The gate path's CUDA kernels (``csrc/circuit_gates.cu``, kernels 5-6
under the kernel precision ``highest``) on the card: against their plain
version on the same card (FP32, the kernels' tiles and gate order), against
float64, against the FP32 dense-operator kernels of
``csrc/circuit2d_grid.cu`` on the same θ (probabilities and dθ through each
path's fold), bit for bit over two runs, and the launch counters of an
exact and a sampled epoch. Past the dense path's 24 qubits, at n = 26,
28 and 30 (HE L=4) and 26 (bn_structured L=8), the machine ``auto``
builds: the probabilities and θ-gradient of a REINFORCE-like loss against
the blocked adjoint executor (complex64, cuBLAS; the reference ansätze
alone) and the benchmark's float64 reference, one launch of each gate
kernel a step, and the step's peak device memory, 14.0 GiB at n = 28
scaled by the state's size.

These tests need a CUDA card and skip without one. On the card, without
the JAX package (the tests' conftest imports it):
``python -m pytest tests/test_torch_circuit_gates_chip.py -m chip --noconftest -q``.

Tolerances, relative to the largest magnitude of the float64 result: the
gate path rounds once per gate and amplitude (24 gates a layer at n = 24,
each four products summed), about L·n·2^-24 ≈ 1e-5 at bn L = 8 after the
errors' growth through |ψ|² and the adjoint; the dense path sums 4096-long
products. The forward is held to 2e-5 and dθ to 2e-4, the grid kernels'
own margins (chip_smoke.py ``TOL``). The wide cases' loss lives on 1024
states, as the sampled estimator's does, so that the θ-gradient is not a
sum of 2^n cancelling terms; they are held at the order of the lean
executor's readings against float64 at n = 32 (q 1.5e-6, θ-gradient
5e-6): ``TOL_Q_WIDE`` and ``TOL_GRAD_WIDE``, 2.6x and 3.2x the largest
readings (q 3.8e-6 against the blocked executor at n = 28; θ-gradient
6.3e-6 against it at n = 28, 9.3e-6 against float64 at bn L=8, n = 26;
HE at n = 30: 3.8e-6 and 3.0e-6; H100 80GB HBM3)."""

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
TOL_Q_WIDE, TOL_GRAD_WIDE = 1e-5, 3e-5
PEAK_28_GIB = 14.0


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


def _shot_loss_grad(bm, theta, shots, coef):
    """q and dθ of the REINFORCE-like loss Σ coef·log q(shot), the gradient
    the sampled estimator takes (dL/dq = coef/q on the shots alone), with
    the launch counts and the peak device memory of the step."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    p = theta.clone().requires_grad_(True)
    q = bm.probs(p)
    (g,) = torch.autograd.grad((coef * torch.log(q[shots])).sum(), p)
    torch.cuda.synchronize()
    return (q.detach(), g, {k: v for k, v in _lib.LAUNCHES.items() if v},
            torch.cuda.max_memory_allocated() / 2**30)


@pytest.mark.parametrize("n,ansatz,L", [(26, HE, 4), (28, HE, 4), (30, HE, 4), (26, BN, 8)])
def test_wide_gate_path_against_the_blocked_adjoint_and_float64(n, ansatz, L, cuda):
    from portbench.reference.circuit import Circuit
    from tensornetworks_tpu_torch.models import QuantumBornMachine

    rng = np.random.default_rng(n)
    theta = 0.1 * rng.normal(size=3 * n * L)
    shots_np = np.sort(rng.choice(1 << n, size=1024, replace=False))
    coef_np = 1e-3 * rng.normal(size=1024)
    th = torch.as_tensor(theta, dtype=torch.float32, device=cuda)
    shots, coef = torch.as_tensor(shots_np, device=cuda), torch.as_tensor(coef_np, device=cuda)
    edges = _edges(n) if ansatz == BN else None

    bm = QuantumBornMachine(n, L, ansatz, edges=edges, device=cuda)
    assert (bm.backend, bm.grad_method) == ("circuit2d_grid", "autodiff")
    q, g, launches, peak = _shot_loss_grad(bm, th, shots, coef.float())
    q_at, q, g = q[shots].double().cpu(), q.cpu(), g.cpu()
    del bm
    err, peak_b = {}, None
    if ansatz == HE:
        blocked = QuantumBornMachine(n, L, backend="blocked", grad_method="adjoint", device=cuda)
        q_b, g_b, launches_b, peak_b = _shot_loss_grad(blocked, th, shots, coef.float())
        assert launches_b == {}, launches_b
        q_b, g_b = q_b.cpu(), g_b.cpu()
        err = {"q blocked": _rel(q, q_b), "dtheta blocked": _rel(g, g_b)}
        del blocked
    torch.cuda.empty_cache()

    # Four blocks on the card: the reference works on pieces of 2^23
    # amplitudes, so that n = 30 fits beside its two complex128 states.
    circ = Circuit(ansatz, n, L, edges or (), [cuda] * 4)
    q64 = torch.cat(circ.probs(theta))
    err |= {"q f64": _rel(q.to(cuda), q64)}
    if ansatz == HE:
        err |= {"q blocked f64": _rel(q_b.to(cuda), q64)}
        del q_b
    del q64
    g64 = torch.zeros(1 << n, dtype=torch.float64, device=cuda)
    g64[shots] = coef / q_at.to(cuda)
    d64 = torch.as_tensor(circ.grad(theta, list(g64.chunk(4))), device="cpu")
    del g64
    err |= {"dtheta f64": _rel(g, d64),
            "dtheta norm f64": abs(float(g.double().norm() / d64.norm()) - 1.0)}
    if ansatz == HE:
        err |= {"dtheta blocked f64": _rel(g_b, d64)}
    print(f"gate path n={n} {ansatz} L={L}: peak {peak:.3f} GiB (blocked adjoint {peak_b}), "
          + ", ".join(f"{k} {v:.2e}" for k, v in err.items()))
    assert launches == {"circuit_gates_fwd": 1, "circuit_gates_bwd": 1}, launches
    for k, v in err.items():  # the blocked executor's own error is printed, not held here
        if "blocked f64" not in k:
            assert v <= (TOL_Q_WIDE if k.startswith("q") else TOL_GRAD_WIDE), (k, v)
    assert peak < PEAK_28_GIB * 2.0 ** (n - 28), peak
