"""Distributed KSD training (``parallel/distributed_train.py``: the
state-sharded Stein matvec, quadratic form and train step) against the JAX
package, after its tests/test_distributed_train.py.

One spawn of 4 gloo ranks on the CPU runs every case, float64 throughout,
on the dp=1 mesh (4 state shards) and, for the n=6 cases, also on the dp=2
mesh (2 state shards). The JAX references are its single-device functions
in the pytest process (``SteinOperator``, ``ansatz_probs``, ``jax.grad``,
optax's Adam), which its own tests pin its distributed ones to: the dense
Gram for n ≤ 7 and, at n = 20, the gcorr-tables operator (its production
path), at 1e-10 for the matvec and the loss, 1e-9 for gradients."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from tensornetworks_tpu.core import get_random_chain_network
from tensornetworks_tpu.ops import SteinOperator, score_table
from tensornetworks_tpu.sim import ansatz_probs, num_ansatz_params
from tensornetworks_tpu_torch.parallel import spawn

import torch_dist_ranks

SHARDS = (4, 2)
Q20_SEED = 0


def _setup(n):
    bn = get_random_chain_network(n + 1, seed=0)
    latent = [f"V{i}" for i in range(n)]
    t = bn.conditional_joint_table(latent, {f"V{n}": 1})
    return score_table(t)


def _single_loss(S_np, n, L):
    op = SteinOperator(S_np, n, dtype=jnp.float64, dense=True)

    def loss(params):
        q = ansatz_probs(params, n, L, "hardware_efficient", dtype=jnp.complex128)
        return op.ksd_loss(q.astype(jnp.float64))
    return loss


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    inp = {"S6": _setup(6), "S7": _setup(7), "S5": _setup(5),
           "q6": rng.dirichlet(np.ones(2**6)),
           "theta6": rng.uniform(0, 2 * np.pi, num_ansatz_params(6, 2, "hardware_efficient")),
           "theta5": 0.1 * rng.normal(size=num_ansatz_params(5, 2, "hardware_efficient")),
           "q20_seed": Q20_SEED}
    out = spawn(torch_dist_ranks.train_cases, 4, "gloo", "cpu", inp, timeout_s=150)
    return inp, out


@pytest.mark.parametrize("shards", SHARDS)
def test_distributed_stein_matvec_matches_single_device(case, shards):
    inp, out = case
    op = SteinOperator(inp["S6"], 6, dtype=jnp.float64, dense=True)
    want = np.asarray(op.matvec(jnp.asarray(inp["q6"])))
    np.testing.assert_allclose(out[f"matvec/D{shards}"], want, rtol=1e-10)


@pytest.mark.parametrize("shards", SHARDS)
def test_distributed_quadform_value_and_grad(case, shards):
    inp, out = case
    op = SteinOperator(inp["S6"], 6, dtype=jnp.float64, dense=True)
    q = jnp.asarray(inp["q6"])
    want = float(op.quadform(q))
    assert abs(out[f"quad/D{shards}"] - want) < 1e-10 * max(1.0, abs(want))
    np.testing.assert_allclose(out[f"quad_grad/D{shards}"], np.asarray(jax.grad(op.quadform)(q)),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("shards", SHARDS)
def test_distributed_ksd_gradients_match_single_device(case, shards):
    """d loss / d θ through the sharded circuit and the sharded operator,
    summed over the state shards, equals the single-device gradient."""
    inp, out = case
    loss, grad = jax.jit(jax.value_and_grad(_single_loss(inp["S6"], 6, 2)))(
        jnp.asarray(inp["theta6"]))
    assert abs(out[f"loss/D{shards}"] - float(loss)) < 1e-10
    np.testing.assert_allclose(out[f"loss_grad/D{shards}"], np.asarray(grad), rtol=1e-9,
                               atol=1e-12)


def test_distributed_state_memory_is_sharded(case):
    """Each rank's q and score rows hold 2^n/D of the 2^n states."""
    _, out = case
    assert out["memory"] == {"q": (2**7 // 4,), "S": (2**7 // 4, 7)}


def test_distributed_train_step_optimizes(case):
    """One distributed step equals the single-device optax step; five more
    reduce the loss; the parameters are equal bit for bit on every rank."""
    inp, out = case
    loss_fn = _single_loss(inp["S5"], 5, 2)
    opt = optax.adam(5e-2)
    p = jnp.asarray(inp["theta5"])
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(p)
    updates, _ = opt.update(grads, opt.init(p), p)
    assert abs(out["step_losses"][0] - float(loss)) < 1e-10
    # Adam divides by sqrt(ν) + 1e-8: round-off in a near-zero gradient
    # component moves its step by up to ~1e-8 relative, hence the JAX test's 1e-6.
    np.testing.assert_allclose(out["step_params"][0], np.asarray(optax.apply_updates(p, updates)),
                               atol=1e-6)
    assert out["step_losses"][-1] < out["step_losses"][0]
    for theta in out["step_params_by_rank"][1:]:
        np.testing.assert_array_equal(theta, out["step_params_by_rank"][0])


def test_distributed_matvec_matches_gcorr_at_20q(case):
    """At n = 20 each of the 4 ranks applies A^{⊗18} (kernel 4's range; its
    plain version here) to its 21 columns; the result equals the JAX
    package's production gcorr-tables matvec."""
    _, out = case
    op = SteinOperator(_setup(20), 20, dtype=jnp.float64, dense=False)
    q = np.random.default_rng(Q20_SEED).dirichlet(np.ones(2**20))
    want = np.asarray(jax.jit(op.matvec)(jnp.asarray(q)))
    np.testing.assert_allclose(out["matvec20"], want, rtol=1e-9, atol=1e-12)
