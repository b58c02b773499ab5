"""The port's grid-form circuit (``ops/kernels/circuit2d_grid.py``, the
plain version of the n ≥ 18 circuit kernels) against the JAX package: the
TPU grid kernel itself in interpret mode, the einsum ansatz and its gradient,
the TPU module's constant banks, and the autograd Function's backward.

The port runs in float64 on the CPU. Against JAX's complex128 ansatz,
probabilities agree to 1e-12 and θ-gradients to 1e-10 (summation order);
against the float32 Pallas kernel in interpret mode, to 5e-6 and 5e-5 (the
JAX package's own tolerances for that kernel); against the TPU module's
banks, built in complex64 there, to 1e-6. The CUDA kernels themselves run
only on the card, in chip_smoke.py. Measured time of this file on the CPU:
about 30 s in one process, most of it JAX tracing the interpret-mode kernel
and the ansatz oracle, and the n=18 maps."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensornetworks_tpu.ops.pallas.circuit2d import _sign_mask_expr as j_sign_mask
from tensornetworks_tpu.ops.pallas.circuit2d_grid import make_pallas_circuit2d_grid_probs
from tensornetworks_tpu.sim import ansatz_probs as j_ansatz_probs
from tensornetworks_tpu.sim.blocked import _chain_gates, _cz_pairs
from tensornetworks_tpu.sim.blocked2d import _kron_h as j_kron_h
from tensornetworks_tpu.sim.blocked2d import _perm_matrix as j_perm_matrix
from tensornetworks_tpu_torch.models import QuantumBornMachine
from tensornetworks_tpu_torch.ops.kernels import _lib
from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg
from tensornetworks_tpu_torch.ops.kernels.circuit2d import expand_maps
from tensornetworks_tpu_torch.sim.ansatz import num_ansatz_params

F64 = torch.float64
ANSATZE = ("hardware_efficient", "basic", "all_to_all")


def _theta(n, L, ansatz, seed=0):
    return np.random.default_rng(seed).uniform(0, 2 * np.pi, num_ansatz_params(n, L, ansatz))


def _grid_qbm(n, L, ansatz):
    return QuantumBornMachine(n, L, ansatz, backend="circuit2d_grid", dtype=F64, device="cpu")


@pytest.mark.parametrize("n", [5, 6])
def test_matches_pallas_grid_kernel_in_interpret_mode(n):
    """HE, L=2: an even layer with CZ and an odd layer without."""
    L, ansatz = 2, "hardware_efficient"
    th = _theta(n, L, ansatz, seed=n)
    v = np.random.default_rng(9).normal(size=2**n)
    fn = make_pallas_circuit2d_grid_probs(n, L, ansatz, interpret=True)
    th32, v32 = jnp.asarray(th, jnp.float32), jnp.asarray(v, jnp.float32)
    p_j = np.asarray(fn(th32))
    g_j = np.asarray(jax.grad(lambda p: fn(p) @ v32)(th32))
    p = torch.as_tensor(th).requires_grad_(True)
    q = _grid_qbm(n, L, ansatz).probs(p)
    (q @ torch.as_tensor(v)).backward()
    np.testing.assert_allclose(q.detach().numpy(), p_j, atol=5e-6, rtol=0)
    np.testing.assert_allclose(p.grad.numpy(), g_j, atol=5e-5, rtol=0)


@pytest.mark.parametrize("ansatz,n,L", [("hardware_efficient", 7, 3), ("basic", 5, 2),
                                        ("all_to_all", 4, 2), ("hardware_efficient", 5, 1)])
def test_probs_and_grad_match_jax_ansatz(ansatz, n, L):
    th = _theta(n, L, ansatz, seed=3 * n + L)
    v = np.random.default_rng(4).normal(size=2**n)

    def f_j(p):
        return j_ansatz_probs(p, n, L, ansatz, dtype=jnp.complex128)

    p_j = np.asarray(jax.jit(f_j)(jnp.asarray(th)))
    g_j = np.asarray(jax.jit(jax.grad(lambda p: f_j(p) @ jnp.asarray(v)))(jnp.asarray(th)))
    p = torch.as_tensor(th).requires_grad_(True)
    q = _grid_qbm(n, L, ansatz).probs(p)
    (q @ torch.as_tensor(v)).backward()
    np.testing.assert_allclose(q.detach().numpy(), p_j, atol=1e-12, rtol=0)
    np.testing.assert_allclose(p.grad.numpy(), g_j, atol=1e-10, rtol=0)


def _jax_banks(n, ansatz):
    """The TPU module's constants, built as ``make_pallas_circuit2d_grid_probs``
    builds them (its ``_w_matrix`` is local there, so it is rebuilt here from
    JAX's ``_kron_h``)."""
    rb, cb = (n + 1) // 2, n // 2
    R, C = 1 << rb, 1 << cb
    chain = _chain_gates(n, ansatz) if ansatz in ("hardware_efficient", "basic") else []

    def w_matrix(H, bits):
        return (H @ np.diag(bits.astype(np.float64)) @ H).astype(np.float32)

    P_col = j_perm_matrix([(c - rb, t - rb) for c, t in chain if c >= rb and t >= rb], cb)
    P_row = j_perm_matrix([(c, t) for c, t in chain if c < rb and t < rb], rb)
    masks = [np.asarray(j_sign_mask(rb, cb, _cz_pairs(n, layer, ansatz)))
             if _cz_pairs(n, layer, ansatz) else None for layer in (0, 1)]
    return {
        "p_row": None if P_row is None else np.real(P_row),
        "p_col": None if P_col is None else np.real(P_col),
        "w_ring": w_matrix(np.real(j_kron_h(rb, 0)), (np.arange(R) >> (rb - 1)) & 1),
        "w_bound": w_matrix(np.real(j_kron_h(cb, 0)), (np.arange(C) >> (cb - 1)) & 1),
        "cz": masks,
    }


@pytest.mark.parametrize("n,ansatz", [(n, a) for n in (2, 3, 6, 7, 12) for a in ANSATZE]
                         + [(18, "hardware_efficient")])
def test_plan_maps_match_jax_banks(n, ansatz):
    """The plan's dense banks equal the TPU module's; its row gather is
    P_row·M; and the index map with the parity's CZ sign (what the CUDA
    kernels apply) equals the TPU kernel's W-form chain on a random state."""
    plan = kg.GridPlan(n, 2, ansatz)
    jb = _jax_banks(n, ansatz)
    tb = plan.banks("cpu", F64)
    for key in ("p_col", "w_ring", "w_bound"):
        if jb[key] is None:
            assert tb[key] is None, key
        else:
            np.testing.assert_allclose(tb[key].numpy(), jb[key], atol=1e-6, err_msg=key)
    for parity in (0, 1):
        if jb["cz"][parity] is None:
            assert tb["cz"][parity] is None
        else:
            np.testing.assert_array_equal(tb["cz"][parity].numpy(), jb["cz"][parity])

    rng = np.random.default_rng(n)
    M = rng.normal(size=(plan.R, plan.R))
    want = M if jb["p_row"] is None else jb["p_row"] @ M
    got = M if plan.row_src is None else M[plan.row_src]
    np.testing.assert_array_equal(got, want)

    X = rng.normal(size=(plan.R, plan.C))
    Y = X.copy()
    if plan.has_chain:
        rmask = (np.arange(plan.C)[None, :] & 1)
        bmask = (np.arange(plan.R)[:, None] & 1)
        if plan.boundary:
            Y = Y - 2.0 * bmask * (Y @ jb["w_bound"])
        if jb["p_col"] is not None:
            Y = Y @ jb["p_col"].T
        if plan.ring:
            Y = Y - 2.0 * rmask * (jb["w_ring"] @ Y)
    assert (plan.rows == plan.rows[0]).all()  # one map on every layer
    dst, sign = expand_maps(plan.rows[0], plan.cz, "cpu")
    for parity in (0, 1):
        s = 1.0 if jb["cz"][parity] is None else jb["cz"][parity]
        Z = np.empty(plan.R * plan.C)
        Z[dst.numpy()] = sign[parity].numpy() * X.reshape(-1)
        np.testing.assert_allclose(Z.reshape(plan.R, plan.C), s * Y, atol=1e-5)


@pytest.mark.parametrize("ansatz,n,L", [("hardware_efficient", 7, 3), ("basic", 4, 2),
                                        ("all_to_all", 5, 2), ("hardware_efficient", 2, 1)])
def test_grid_function_backward_matches_autograd(ansatz, n, L):
    """The Function's backward (a transcription of the TPU grid kernel's
    adjoint sweep) against autograd through the plain forward, on the same
    operator planes; CPU tensors count no launch."""
    plan = kg.GridPlan(n, L, ansatz)
    th = torch.as_tensor(_theta(n, L, ansatz, seed=5))
    planes = [t.detach().requires_grad_(True) for t in kg.grid_operators(th, plan)]
    g = torch.as_tensor(np.random.default_rng(6).normal(size=(plan.R, plan.C)))
    before = dict(_lib.LAUNCHES)
    probs = kg.Circuit2dGridFunction.apply(*planes, plan)
    grads = torch.autograd.grad((probs * g).sum(), planes)
    assert _lib.LAUNCHES == before
    ref_planes = [p.detach().clone().requires_grad_(True) for p in planes]
    ref = kg.circuit2d_grid_forward_plain(*ref_planes, plan)[0]
    np.testing.assert_allclose(probs.detach().numpy(), ref.detach().numpy(), atol=1e-13)
    ref_grads = torch.autograd.grad((ref * g).sum(), ref_planes)
    for a, b in zip(grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-11, rtol=0)


def test_backend_ranges_and_plan_validation():
    """``auto``'s ranges for an FP32 machine under ``highest`` (the gate
    path to 30 qubits), and each path's own limit: the operator path's
    (``high``, ``default``) 24, the gate path's 30."""
    for n, backend in ((2, "circuit2d"), (17, "circuit2d"), (18, "circuit2d_grid"),
                       (kg.MAX_QUBITS, "circuit2d_grid"), (kg.MAX_QUBITS + 1, "circuit2d_grid"),
                       (kg.GATE_MAX_QUBITS, "circuit2d_grid"),
                       (kg.GATE_MAX_QUBITS + 1, "blocked"), (1, "einsum")):
        assert QuantumBornMachine(n, 1, device="cpu").backend == backend, n
    assert kg.MAX_QUBITS >= 22 and kg.GATE_MAX_QUBITS == 30
    for precision in ("high", "default"):
        kg.GridPlan(kg.MAX_QUBITS, 1, "basic", precision=precision)
        with pytest.raises(ValueError):
            kg.GridPlan(kg.MAX_QUBITS + 1, 1, "basic", precision=precision)
    kg.GridPlan(kg.GATE_MAX_QUBITS, 1, "basic", precision="highest")
    with pytest.raises(ValueError):
        kg.GridPlan(kg.GATE_MAX_QUBITS + 1, 1, "basic", precision="highest")
    with pytest.raises(ValueError):
        kg.GridPlan(1, 1, "basic")
    with pytest.raises(ValueError):
        kg.GridPlan(4, 0, "basic")
    plan = kg.GridPlan(18, 4, "hardware_efficient")
    assert (plan.R, plan.C) == (512, 512) and plan.cz.shape == plan.rows.shape == (4, 18)
    assert plan.cz[1::2].sum() == 0 and (plan.cz[0::2].sum(axis=1) > 0).all()  # even layers
