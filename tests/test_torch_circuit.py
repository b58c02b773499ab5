"""The port's circuit simulator against the JAX package: the three backends
(einsum, the plain blocked2d matmul form, and the circuit kernels' plain
version), their gradients, the recorded reference fixtures, and the adjoint
backward of the circuit kernel's autograd Function.

The port runs in float64 on the CPU and JAX in complex128 (conftest enables
x64), so probabilities agree to 1e-12 and gradients to 1e-10; against the
float32 Pallas kernel in interpret mode and the fixtures, 1e-6 (the
fixtures' own float32 precision). The CUDA kernels themselves run only on
the card, in chip_smoke.py."""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensornetworks_tpu.sim import ansatz_probs as j_ansatz_probs
from tensornetworks_tpu.sim.blocked import _chain_gates, _cnot_map
from tensornetworks_tpu.sim.blocked2d import make_blocked2d_probs_fn as j_blocked2d
from tensornetworks_tpu.sim.blocked2d import _perm_matrix as j_perm_matrix
from tensornetworks_tpu.sim.gates import kron_fold as j_kron_fold
from tensornetworks_tpu.sim.gates import rot_zyx_batched as j_rot_zyx
from tensornetworks_tpu_torch.models import QuantumBornMachine
from tensornetworks_tpu_torch.ops.kernels import _lib
from tensornetworks_tpu_torch.ops.kernels import circuit2d as kc
from tensornetworks_tpu_torch.sim import blocked2d as tb2d
from tensornetworks_tpu_torch.sim import gates as tgates
from tensornetworks_tpu_torch.sim.ansatz import num_ansatz_params

F64 = torch.float64
ANSATZE = ("hardware_efficient", "basic", "all_to_all")
FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "fixtures",
                                         "quantum_ref_*.npz")))


def _theta(n, L, ansatz, seed=0):
    return np.random.default_rng(seed).uniform(0, 2 * np.pi, num_ansatz_params(n, L, ansatz))


def _qbm(n, L, ansatz, backend):
    return QuantumBornMachine(n, L, ansatz, backend=backend, dtype=F64, device="cpu")


@pytest.mark.parametrize("backend", ["circuit2d", "blocked2d", "einsum"])
@pytest.mark.parametrize("ansatz", ANSATZE)
@pytest.mark.parametrize("n", [3, 4, 6, 7])
def test_probs_match_jax_ansatz(n, ansatz, backend):
    L = 3
    th = _theta(n, L, ansatz, seed=n)
    p_j = np.asarray(j_ansatz_probs(jnp.asarray(th), n, L, ansatz, dtype=jnp.complex128))
    p_t = _qbm(n, L, ansatz, backend).probs(torch.as_tensor(th))
    np.testing.assert_allclose(p_t.numpy(), p_j, atol=1e-12, rtol=0)


@pytest.mark.parametrize("ansatz", ANSATZE)
def test_blocked2d_matches_jax_blocked2d(ansatz):
    n, L = 5, 2
    th = _theta(n, L, ansatz, seed=7)
    p_j = np.asarray(j_blocked2d(n, L, ansatz, dtype=jnp.complex128)(jnp.asarray(th)))
    p_t = tb2d.make_blocked2d_probs_fn(n, L, ansatz)(torch.as_tensor(th))
    np.testing.assert_allclose(p_t.numpy(), p_j, atol=1e-12, rtol=0)


@pytest.mark.parametrize("backend", ["circuit2d", "einsum"])
@pytest.mark.parametrize("path", FIXTURES, ids=[os.path.basename(p) for p in FIXTURES])
def test_probs_match_recorded_fixtures(path, backend):
    fx = np.load(path)
    n, L, ansatz = int(fx["n"]), int(fx["layers"]), str(fx["ansatz"])
    p = _qbm(n, L, ansatz, backend).probs(torch.as_tensor(fx["theta"], dtype=F64))
    np.testing.assert_allclose(p.numpy(), fx["probs"], atol=1e-6)


@pytest.mark.parametrize("backend", ["circuit2d", "blocked2d"])
def test_grad_matches_jax_grad(backend):
    n, L, ansatz = 6, 3, "hardware_efficient"
    th = _theta(n, L, ansatz, seed=11)
    v = np.random.default_rng(12).normal(size=2**n)
    g_j = np.asarray(jax.grad(lambda p: j_ansatz_probs(p, n, L, ansatz, dtype=jnp.complex128)
                              @ jnp.asarray(v))(jnp.asarray(th)))
    p = torch.as_tensor(th).requires_grad_(True)
    (_qbm(n, L, ansatz, backend).probs(p) @ torch.as_tensor(v)).backward()
    np.testing.assert_allclose(p.grad.numpy(), g_j, atol=1e-10, rtol=0)


@pytest.mark.parametrize("ansatz,n,L", [("hardware_efficient", 7, 3), ("basic", 3, 2),
                                        ("all_to_all", 4, 2), ("hardware_efficient", 2, 1)])
def test_adjoint_backward_matches_autograd_through_blocked2d(ansatz, n, L):
    """The circuit Function's backward (a transcription of the backward
    kernel) against plain autograd on the same Mr/Mc operator planes."""
    plan = kc.CircuitPlan(n, L, ansatz)
    th = torch.as_tensor(_theta(n, L, ansatz, seed=3))
    Mr, Mc = tgates.rotation_operators(th, n, L, plan.per_qubit)
    planes = [t.contiguous().requires_grad_(True) for t in (Mr.real, Mr.imag, Mc.real, Mc.imag)]
    g = torch.as_tensor(np.random.default_rng(4).normal(size=(plan.R, plan.C)))
    before = dict(_lib.LAUNCHES)
    probs = kc.Circuit2dFunction.apply(*planes, plan)
    grads = torch.autograd.grad((probs * g).sum(), planes)
    assert _lib.LAUNCHES == before  # CPU tensors run the plain versions

    # The same function through autograd: the blocked2d matmul formulation
    # (H·mask·H cross-boundary CNOTs, permutation matrices) on the same
    # operators, with no custom backward.
    ref_planes = [p.detach().clone().requires_grad_(True) for p in planes]
    X = tb2d.Blocked2dCircuit(n, L, ansatz).state(torch.complex(*ref_planes[:2]),
                                                  torch.complex(*ref_planes[2:]))
    ref = X.real**2 + X.imag**2
    np.testing.assert_allclose(probs.detach().numpy(), ref.detach().numpy(), atol=1e-13)
    ref_grads = torch.autograd.grad((ref * g).sum(), ref_planes)
    for a, b in zip(grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-11, rtol=0)


@pytest.mark.parametrize("ansatz", ANSATZE)
@pytest.mark.parametrize("n", [2, 3, 8, 17])
def test_plan_masks_are_the_composed_cnot_chain(n, ansatz):
    """The GF(2) row masks the kernels receive reproduce the layer's CNOT
    chain composed gate by gate with the JAX package's _cnot_map."""
    plan = kc.CircuitPlan(n, 2, ansatz)
    dst, sign = plan.tables("cpu")
    idx = np.arange(1 << n, dtype=np.int64)
    want = idx.copy()
    if ansatz != "all_to_all":
        for c, t in _chain_gates(n, ansatz):
            want = _cnot_map(want, n, c, t)
    np.testing.assert_array_equal(dst.numpy(), want)
    assert set(np.unique(sign.numpy())) <= {-1.0, 1.0}


def test_perm_and_rotations_match_jax():
    P = tb2d._perm_matrix([(0, 1), (1, 2)], 3)
    np.testing.assert_array_equal(P, np.asarray(j_perm_matrix([(0, 1), (1, 2)], 3)))
    a = np.random.default_rng(5).normal(size=(2, 3, 3))
    U_t = tgates.rot_zyx_batched(*(torch.as_tensor(a[..., i]) for i in range(3)))
    U_j = j_rot_zyx(*(jnp.asarray(a[..., i]) for i in range(3)))
    np.testing.assert_allclose(U_t.numpy(), np.asarray(U_j), atol=1e-14)
    K_t = tgates.kron_fold([U_t[:, q] for q in range(3)])
    K_j = j_kron_fold([U_j[:, q] for q in range(3)])
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), atol=1e-14)


def test_circuit_plan_rejects_out_of_range():
    with pytest.raises(ValueError):
        kc.CircuitPlan(18, 1, "basic")
    with pytest.raises(ValueError):
        kc.CircuitPlan(4, 0, "basic")
    with pytest.raises(ValueError):
        QuantumBornMachine(4, 1, backend="pallas2d", device="cpu")


def test_matches_pallas_kernel_in_interpret_mode():
    """One n=4 case against the TPU kernel itself, run by JAX's interpreter
    (float32, so 1e-6 on probabilities and 1e-5 on gradients)."""
    from tensornetworks_tpu.ops.pallas.circuit2d import make_pallas_circuit2d_probs

    n, L, ansatz = 4, 2, "hardware_efficient"
    th = _theta(n, L, ansatz, seed=21)
    v = np.random.default_rng(22).normal(size=2**n)
    fn = make_pallas_circuit2d_probs(n, L, ansatz, interpret=True)
    p_j = np.asarray(fn(jnp.asarray(th, jnp.float32)))
    g_j = np.asarray(jax.grad(lambda p: fn(p) @ jnp.asarray(v, jnp.float32))(
        jnp.asarray(th, jnp.float32)))
    p = torch.as_tensor(th).requires_grad_(True)
    q = _qbm(n, L, ansatz, "circuit2d").probs(p)
    (q @ torch.as_tensor(v)).backward()
    np.testing.assert_allclose(q.detach().numpy(), p_j, atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), g_j, atol=1e-5)


def test_get_prob_dict_and_init():
    qbm = QuantumBornMachine(3, 2, device="cpu", dtype=F64)
    th = qbm.init(torch.Generator().manual_seed(0))
    assert th.shape == (18,) and th.dtype == F64 and float(th.abs().max()) < 1.0
    d = qbm.get_prob_dict(th)
    assert len(d) == 8 and abs(sum(d.values()) - 1.0) < 1e-12
    z = QuantumBornMachine(3, 2, init_method="zero", device="cpu").init(torch.Generator())
    assert float(z.abs().max()) == 0.0
