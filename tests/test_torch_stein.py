"""The port's Stein operator math against the JAX package: dense Gram,
3n+1 matvec, the stein2d kernel's plain version, the operator's quadratic
form and its gradient.

Both packages run in float64 on the CPU (conftest enables x64), so the
tolerance is set by summation order: 1e-10 relative to the result's scale.
The stein2d CUDA kernel itself runs only on the card, in chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensornetworks_tpu.core import all_bitstrings as j_all_bitstrings
from tensornetworks_tpu.core import get_random_chain_network as j_chain
from tensornetworks_tpu.ops import kron as jkron
from tensornetworks_tpu.ops import stein as jstein
from tensornetworks_tpu_torch.core import get_random_chain_network as t_chain
from tensornetworks_tpu_torch.ops import kron as tkron
from tensornetworks_tpu_torch.ops import stein as tstein
from tensornetworks_tpu_torch.ops.kernels import stein2d as tk
from tensornetworks_tpu_torch.ops.kernels import _lib

F64 = torch.float64


def _score(n, seed=0):
    latent, obs = [f"V{i}" for i in range(n)], {f"V{n}": 1}
    t = t_chain(n + 1, seed=seed).conditional_joint_table(latent, obs)
    np.testing.assert_array_equal(
        t, j_chain(n + 1, seed=seed).conditional_joint_table(latent, obs))
    return tstein.score_table(t)


def _q(n, seed=1):
    q = np.random.default_rng(seed).random(2**n)
    return q / q.sum()


def _close(a, b, rel=1e-10):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=rel * np.abs(b).max())


@pytest.mark.parametrize("n,ls", [(3, 1.0), (8, 1.0), (8, 0.125)])
def test_stein_gram_dense_matches_jax(n, ls):
    S = _score(n)
    g_t = tstein.stein_gram_dense(torch.as_tensor(S), n, ls)
    g_j = jstein.stein_gram_dense(jnp.asarray(S), n, ls, dtype=jnp.float64)
    _close(g_t, g_j)


@pytest.mark.parametrize("n", [3, 8])
def test_stein_matvec_matches_jax(n):
    S, q = _score(n), _q(n)
    B = j_all_bitstrings(n).astype(np.float64)
    y_t = tstein.stein_matvec(torch.as_tensor(q), torch.as_tensor(S), torch.as_tensor(B), n)
    y_j = jstein.stein_matvec(jnp.asarray(q), jnp.asarray(S), jnp.asarray(B), n)
    _close(y_t, y_j)
    # ... and the matvec is the dense Gram applied to q.
    _close(y_t, tstein.stein_gram_dense(torch.as_tensor(S), n) @ torch.as_tensor(q))


@pytest.mark.parametrize("n", [13, 16])
def test_stein2d_path_matches_jax(n):
    """The 2D-split oracle, the stein2d kernel's plain version inside the
    operator, and the operator's quadratic form, all against JAX."""
    S, q = _score(n), _q(n)
    B = j_all_bitstrings(n).astype(np.float64)
    y_j = np.asarray(jstein.stein_matvec(jnp.asarray(q), jnp.asarray(S), jnp.asarray(B), n))
    y_t = tstein.stein_matvec(torch.as_tensor(q), torch.as_tensor(S), torch.as_tensor(B), n)
    _close(y_t, y_j)
    op_t = tstein.SteinOperator(S, n, dtype=F64, device="cpu")
    assert not op_t.dense
    # The kernel takes contiguous operands only: V = Vw∘q must come out so.
    V = (op_t._Vw * torch.as_tensor(q)).reshape(-1, op_t._R, op_t._C)
    assert V.is_contiguous() and op_t._W.is_contiguous()
    before = dict(_lib.LAUNCHES)
    _close(op_t.matvec(torch.as_tensor(q)), y_j)
    op_j = jstein.SteinOperator(S, n, dtype=jnp.float64)
    qf_j = float(op_j.quadform(jnp.asarray(q)))
    np.testing.assert_allclose(float(op_t.quadform(torch.as_tensor(q))), qf_j, rtol=1e-10)
    assert _lib.LAUNCHES == before  # CPU tensors never reach a kernel


def test_stein2d_plain_is_the_two_sided_kronecker_apply():
    n = 7
    a = 0.6
    A = np.array([[1.0, a], [a, 1.0]])
    rb, cb = 4, 3
    V = np.random.default_rng(0).normal(size=(5, 1 << rb, 1 << cb))
    Y = tk.stein2d_apply(a, torch.as_tensor(V))
    Ar, Ac = tk.kron_factors(a, 1 << rb, 1 << cb, F64)
    np.testing.assert_array_equal(Ar.numpy(), tkron.kron_power_np(A, rb))
    np.testing.assert_array_equal(Ac.numpy(), tkron.kron_power_np(A, cb))
    K = jkron.kron_power_np(A, n)
    _close(Y.reshape(5, -1), V.reshape(5, -1) @ K.T)


@pytest.mark.parametrize("n", [4, 9])
def test_kron_matvec_matches_jax(n):
    A = np.array([[1.0, 0.3], [0.3, 1.0]])
    v = np.random.default_rng(n).normal(size=(2**n, 3))
    _close(tkron.kron_matvec(torch.as_tensor(v), A, n, group=3),
           jkron.kron_matvec(jnp.asarray(v), A, n, group=3))
    np.testing.assert_array_equal(tkron.kron_power_np(A, 3), jkron.kron_power_np(A, 3))


@pytest.mark.parametrize("n,dense", [(8, True), (8, False), (13, False)])
def test_operator_ksd_loss_and_grad_match_jax(n, dense):
    S, q = _score(n, seed=2), _q(n, seed=3)
    op_t = tstein.SteinOperator(S, n, length_scale=0.5, dtype=F64, dense=dense, device="cpu")
    op_j = jstein.SteinOperator(S, n, length_scale=0.5, dtype=jnp.float64, dense=dense)
    qt = torch.as_tensor(q).requires_grad_(True)
    loss_t = op_t.ksd_loss(qt)
    (g_t,) = torch.autograd.grad(loss_t, qt)
    loss_j, g_j = jax.value_and_grad(op_j.ksd_loss)(jnp.asarray(q))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-10)
    _close(g_t, g_j)


def test_ksd_quadform_gradcheck():
    n = 4
    S = torch.as_tensor(_score(n))
    B = torch.as_tensor(j_all_bitstrings(n).astype(np.float64))
    q = torch.as_tensor(_q(n)).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda v: tstein.ksd_quadform(v, S, B, n, 0.7), (q,))


def test_score_table_zero_rows():
    t = np.array([0.0, 0.2, 0.3, 0.5])
    S = tstein.score_table(t)
    np.testing.assert_array_equal(S, jstein.score_table(t))
    assert np.all(S[0] == 0.0)
    with pytest.raises(ValueError):
        tstein.score_table(np.ones(3))
