"""The port's blocked executor and its adjoint backward against the JAX
package: ``make_blocked_probs_fn`` (autograd, and with ``remat_layers``)
and ``make_blocked_adjoint_probs_fn``, probabilities and θ-gradients in
complex128, for the three reference ansätze at n=5 (one block), n=9 with
``block=8`` (a remainder block of one qubit) and n=7 with ``block=3``
(three blocks). Each port path is also held against the port's per-gate
adjoint (``sim/adjoint.py``, which shares no code with the blocked
executor) and its ``einsum`` backend. Tolerances: probabilities 1e-12
absolute; gradients 1e-10 of the largest gradient component, as the JAX
package holds its own adjoint (``tests/test_blocked_adjoint.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensornetworks_tpu.sim import adjoint as jadjoint
from tensornetworks_tpu.sim import blocked as jblocked
from tensornetworks_tpu.sim.blocked_adjoint import make_blocked_adjoint_probs_fn as j_adjoint
from tensornetworks_tpu_torch.models import QuantumBornMachine
from tensornetworks_tpu_torch.ops.kernels import precision as kp
from tensornetworks_tpu_torch.ops.kron import apply_adjacent_block
from tensornetworks_tpu_torch.sim import adjoint, blocked
from tensornetworks_tpu_torch.sim.ansatz import ansatz_probs, num_ansatz_params
from tensornetworks_tpu_torch.sim.blocked_adjoint import make_blocked_adjoint_probs_fn

F64, C128 = torch.float64, torch.complex128
ANSATZE = ["hardware_efficient", "all_to_all", "basic"]
SHAPES = [(5, 2, 8), (9, 2, 8), (7, 3, 3)]  # (n, layers, block)


@pytest.fixture
def kernel_precision():
    """Sets the kernel precision for machines built in the test; restores it."""
    old = kp._kernel_precision()
    yield kp.set_kernel_precision
    kp.set_kernel_precision(old)


def _loss_weights(n, seed=3):
    return np.random.default_rng(seed).normal(size=1 << n)


def _torch_loss(probs_fn, theta, w):
    """A real loss touching every outcome with distinct weights (catches a
    conjugation, transpose or factor-of-2 slip a symmetric loss hides)."""
    p = theta.clone().requires_grad_(True)
    q = probs_fn(p)
    n_half = q.shape[0] // 2
    loss = (torch.as_tensor(w) * q ** 2).sum() + torch.sin(q[:n_half]).sum()
    (grad,) = torch.autograd.grad(loss, p)
    return q.detach().numpy(), grad.numpy()


def _jax_loss(probs_fn, theta, w):
    def loss(t):
        q = probs_fn(t)
        return jnp.sum(w * q ** 2) + jnp.sum(jnp.sin(q[: q.shape[0] // 2]))
    return np.asarray(probs_fn(jnp.asarray(theta))), np.asarray(jax.grad(loss)(jnp.asarray(theta)))


@pytest.mark.parametrize("n,layers,block", SHAPES)
@pytest.mark.parametrize("ansatz", ANSATZE)
def test_blocked_executors_match_jax(ansatz, n, layers, block):
    theta = np.random.default_rng(n * 7 + layers).normal(size=num_ansatz_params(n, layers, ansatz))
    w = _loss_weights(n)
    jq, jg = _jax_loss(jblocked.make_blocked_probs_fn(n, layers, ansatz, block=block,
                                                      dtype=jnp.complex128), theta, w)
    tol = 1e-10 * np.abs(jg).max()
    paths = {
        "blocked": blocked.make_blocked_probs_fn(n, layers, ansatz, block, C128),
        "blocked remat": blocked.make_blocked_probs_fn(n, layers, ansatz, block, C128,
                                                       remat_layers=True),
        "blocked adjoint": make_blocked_adjoint_probs_fn(n, layers, ansatz, block, C128),
        "per-gate adjoint": adjoint.make_adjoint_probs_fn(n, layers, ansatz, C128),
        "einsum": lambda t: ansatz_probs(t, n, layers, ansatz),
    }
    theta_t = torch.as_tensor(theta)
    for name, fn in paths.items():
        q, g = _torch_loss(fn, theta_t, w)
        np.testing.assert_allclose(q, jq, rtol=0, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(g, jg, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("adjoint_kind", ["blocked", "per-gate"])
def test_adjoints_match_their_jax_counterparts(adjoint_kind):
    """Each port adjoint against the JAX adjoint of the same kind (the
    JAX package's ``custom_vjp`` functions), hardware_efficient n=5, L=2."""
    n, layers, ansatz = 5, 2, "hardware_efficient"
    theta = np.random.default_rng(1).normal(size=num_ansatz_params(n, layers, ansatz))
    w = _loss_weights(n)
    if adjoint_kind == "blocked":
        fj = j_adjoint(n, layers, ansatz, block=3, dtype=jnp.complex128)
        ft = make_blocked_adjoint_probs_fn(n, layers, ansatz, 3, C128)
    else:
        fj = jadjoint.make_adjoint_probs_fn(n, layers, ansatz, jnp.complex128)
        ft = adjoint.make_adjoint_probs_fn(n, layers, ansatz, C128)
    jq, jg = _jax_loss(fj, theta, w)
    q, g = _torch_loss(ft, torch.as_tensor(theta), w)
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-12)
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-10 * np.abs(jg).max())


def test_born_machine_blocked_backend_and_adjoint(kernel_precision):
    """``QuantumBornMachine``: ``auto`` takes ``blocked`` from 25 qubits
    where the grid kernels' gate path does not run the machine (under
    ``high``; past 30 qubits) and for ``grad_method="adjoint"``; the
    adjoint model's probabilities and gradient are the autograd model's;
    bn_structured has no blocked path."""
    kernel_precision("highest")
    assert QuantumBornMachine(25, 1, device="cpu").backend == "circuit2d_grid"
    assert QuantumBornMachine(31, 1, device="cpu").backend == "blocked"
    assert QuantumBornMachine(24, 1, device="cpu").backend == "circuit2d_grid"
    kernel_precision("high")
    assert QuantumBornMachine(25, 1, device="cpu").backend == "blocked"
    assert QuantumBornMachine(24, 1, device="cpu").backend == "circuit2d_grid"
    kernel_precision("highest")
    n, layers = 6, 2
    adj = QuantumBornMachine(n, layers, grad_method="adjoint", dtype=F64, device="cpu", block=4)
    ad = QuantumBornMachine(n, layers, backend="blocked", dtype=F64, device="cpu", block=4)
    assert adj.backend == ad.backend == "blocked"
    theta = torch.as_tensor(np.random.default_rng(0).normal(size=adj.num_params))
    w = _loss_weights(n)
    (qa, ga), (qb, gb) = _torch_loss(adj.probs, theta, w), _torch_loss(ad.probs, theta, w)
    np.testing.assert_allclose(qa, qb, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ga, gb, rtol=0, atol=1e-10 * np.abs(gb).max())
    with pytest.raises(ValueError, match="adjoint"):
        QuantumBornMachine(n, 1, "bn_structured", edges=[(0, 1)], grad_method="adjoint",
                           device="cpu")
    with pytest.raises(ValueError, match="blocked"):
        QuantumBornMachine(n, 1, backend="einsum", grad_method="adjoint", device="cpu")
    with pytest.raises(ValueError, match="circuit kernels"):
        QuantumBornMachine(31, 1, "bn_structured", edges=[(0, 1)], device="cpu")
    kernel_precision("high")
    with pytest.raises(ValueError, match="circuit kernels"):
        QuantumBornMachine(25, 1, "bn_structured", edges=[(0, 1)], device="cpu")


@pytest.mark.parametrize("n,ansatz", [(7, "hardware_efficient"), (5, "basic"), (1, "basic")])
def test_blocked_helpers_match_jax(n, ansatz):
    np.testing.assert_array_equal(blocked._blocks(n, 3), jblocked._blocks(n, 3))
    perm_t, perm_j = blocked._chain_permutation(n, ansatz), jblocked._chain_permutation(n, ansatz)
    assert (perm_t is None) == (perm_j is None)
    if perm_t is not None:
        np.testing.assert_array_equal(perm_t, perm_j)
    gates = blocked._chain_gates(n, ansatz)
    for start, size in blocked._blocks(n, 3):
        t, j = (blocked._local_perm_matrix(gates, start, size),
                jblocked._local_perm_matrix(gates, start, size))
        assert (t is None) == (j is None)
        if t is not None:
            np.testing.assert_array_equal(t, j)
    pairs = blocked._cz_pairs(n, 0, "hardware_efficient") + [(0, n - 1)]
    host = blocked._cz_diag(n, pairs)
    np.testing.assert_array_equal(host, jblocked._cz_diag(n, pairs))
    np.testing.assert_array_equal(blocked._cz_diag_device(n, pairs, device="cpu").numpy(), host)
    np.testing.assert_allclose(blocked._hadamard_block(3), jblocked._hadamard_block(3), atol=1e-7)


@pytest.mark.parametrize("start,g", [(0, 3), (2, 3), (4, 3), (1, 1)])
def test_apply_adjacent_block_matches_jax(start, g):
    from tensornetworks_tpu.ops.kron import apply_adjacent_block as j_apply

    n = 7
    rng = np.random.default_rng(start + g)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    M = rng.normal(size=(1 << g, 1 << g)) + 1j * rng.normal(size=(1 << g, 1 << g))
    np.testing.assert_allclose(apply_adjacent_block(torch.as_tensor(v), torch.as_tensor(M),
                                                    start, g, n).numpy(),
                               np.asarray(j_apply(jnp.asarray(v), jnp.asarray(M), start, g, n)),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("ansatz", ["hardware_efficient", "bn_structured"])
def test_primitive_program_matches_jax(ansatz):
    edges = [(0, 2), (1, 2), (2, 3)] if ansatz == "bn_structured" else None
    assert (adjoint.primitive_ansatz_program(4, 3, ansatz, edges)
            == jadjoint.primitive_ansatz_program(4, 3, ansatz, edges))
