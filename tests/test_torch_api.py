"""The reference API that no earlier slice needed (ROADMAP A13), against the
JAX package: the bit codecs, the Bayesian network's log joint, joint
probability, forward sampling and likelihood-weighted marginals (the same
seed gives the same draws, bit for bit), the Hamming kernel functions and
``score_table_from_log`` (1e-12), ``QuantumBornMachine.state`` (complex128,
1e-10) and ``all_outcome_tuples``, and the ``ksd_quantum`` alias module.

``state`` on the circuit backends is the final state of the kernels'
forward, here their plain version on the CPU (the grid's at n=18); the
card holds the kernels to it in chip_smoke.py. The JAX model reads x as
float32, so the conditioned cases pass it float64 through a ``jnp`` whose
float32 is float64 (patched in its module only)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensornetworks_tpu.core import bits as jbits
from tensornetworks_tpu.core import get_random_chain_network as j_chain
from tensornetworks_tpu.core import get_sprinkler_network as j_sprinkler
from tensornetworks_tpu.models import QuantumBornMachine as JQBM
from tensornetworks_tpu.models import born_quantum as jborn
from tensornetworks_tpu.ops import hamming as jhamming
from tensornetworks_tpu.ops import stein as jstein
from tensornetworks_tpu_torch.core import (get_binary_key, get_outcome_tuple,
                                           get_random_chain_network, get_sprinkler_network,
                                           popcount)
from tensornetworks_tpu_torch.engines import QuantumKSDVariationalInference
from tensornetworks_tpu_torch.models import QuantumBornMachine
from tensornetworks_tpu_torch.ops import (base_hamming_kernel, hamming_distance,
                                          hamming_kernel_matrix, score_table,
                                          score_table_from_log)
from tensornetworks_tpu_torch.sim.structured import latent_edges

F64 = torch.float64


class F64Jnp:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_bit_codecs_match_jax():
    x = np.array([0, 1, 2, 3, 255, 2**40 + 5, 12345])
    np.testing.assert_array_equal(popcount(x), jbits.popcount(x.copy()))
    # The port leaves its input as it was; the JAX function zeroes an int64
    # input in place (ROADMAP §C).
    assert popcount(x)[5] == 3 and x[5] == 2**40 + 5
    y = x.copy()
    jbits.popcount(y)
    assert not y.any()
    np.testing.assert_array_equal(popcount(np.array([0, 1, 2, 3, 255])), [0, 1, 1, 2, 8])
    for t in [(1, 0, 1), (0,), (1, 1, 0, 0, 1)]:
        assert get_binary_key(t) == jbits.get_binary_key(t)
        assert get_outcome_tuple(get_binary_key(t)) == jbits.get_outcome_tuple("".join(map(str, t)))
    assert get_binary_key((1, 0, 1)) == "101" and get_outcome_tuple("101") == (1, 0, 1)


@pytest.mark.parametrize("make", ["sprinkler", "chain"])
def test_bayes_net_api_matches_jax(make):
    if make == "sprinkler":
        bn, jbn = get_sprinkler_network(), j_sprinkler()
    else:
        bn, jbn = get_random_chain_network(9, seed=3), j_chain(9, seed=3)
    np.testing.assert_allclose(bn.log_joint_table(), jbn.log_joint_table(), rtol=1e-12, atol=0)
    rng = np.random.default_rng(1)
    for row in rng.integers(0, 2, size=(5, bn.num_nodes)):
        assert bn.get_joint_probability(tuple(row)) == pytest.approx(
            jbn.get_joint_probability(tuple(row)), rel=1e-12, abs=0)
    with pytest.raises(ValueError, match="length"):
        bn.get_joint_probability((0,))
    dicts, tuples = bn.sample_forward(500, seed=7)
    jdicts, jtuples = jbn.sample_forward(500, seed=7)
    assert tuples == jtuples and dicts == jdicts
    latent = bn.nodes[:-1]
    obs = {bn.nodes[-1]: 1}
    assert (bn.likelihood_weighted_marginals(latent, obs, num_samples=20_000, seed=3)
            == jbn.likelihood_weighted_marginals(latent, obs, num_samples=20_000, seed=3))


def test_likelihood_weighted_marginals_converge_to_the_exact_marginals():
    n = 10
    bn = get_random_chain_network(n + 1, seed=4)
    latent = [f"V{i}" for i in range(n)]
    obs = {f"V{n}": 1}
    p = bn.posterior_vector(latent, obs).reshape((2,) * n)
    exact = {latent[i]: float(p.sum(axis=tuple(j for j in range(n) if j != i))[1])
             for i in range(n)}
    est = bn.likelihood_weighted_marginals(latent, obs, num_samples=200_000, seed=0)
    assert est.pop("__ess__") > 10_000
    for nm in latent:
        assert abs(est[nm] - exact[nm]) < 0.01


@pytest.mark.parametrize("n,ls", [(0, 1.0), (3, 1.0), (5, 0.2)])
def test_hamming_functions_match_jax(n, ls):
    rng = np.random.default_rng(n)
    z1 = rng.integers(0, 2, size=(4, 3, n)).astype(np.float64)
    z2 = rng.integers(0, 2, size=(1, 3, n)).astype(np.float64)
    t1, t2 = torch.as_tensor(z1), torch.as_tensor(z2)
    np.testing.assert_allclose(hamming_distance(t1, t2).numpy(),
                               np.asarray(jhamming.hamming_distance(z1, z2)), atol=1e-12)
    np.testing.assert_allclose(base_hamming_kernel(t1, t2, n, ls).numpy(),
                               np.asarray(jhamming.base_hamming_kernel(jnp.asarray(z1),
                                                                       jnp.asarray(z2), n, ls)),
                               rtol=1e-12, atol=0)
    K = hamming_kernel_matrix(n, ls, dtype=F64, device="cpu")
    np.testing.assert_allclose(K.numpy(), np.asarray(jhamming.hamming_kernel_matrix(
        n, ls, dtype=jnp.float64)), rtol=1e-12, atol=0)


@pytest.mark.parametrize("n", [1, 4, 7])
def test_score_table_from_log_matches_jax(n):
    bn = get_random_chain_network(n + 1, seed=n)
    latent = [f"V{i}" for i in range(n)]
    t = bn.conditional_joint_table(latent, {f"V{n}": 1})
    t[::3] = 0.0  # zero rows: the guard
    log_t = np.log(np.maximum(t, 1e-300))
    got = score_table_from_log(torch.as_tensor(log_t), n).numpy()
    np.testing.assert_allclose(got, np.asarray(jstein.score_table_from_log(jnp.asarray(log_t), n)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, score_table(t), rtol=1e-12, atol=1e-12)
    assert score_table_from_log(torch.zeros(1, dtype=F64), 0).shape == (1, 0)


STATE_CASES = [(n, L, ansatz) for n, L, ansatz in
               [(3, 1, "hardware_efficient"), (4, 2, "hardware_efficient"),
                (5, 2, "all_to_all"), (6, 1, "all_to_all"), (3, 2, "basic"), (6, 2, "basic"),
                (5, 1, "hardware_efficient")]]


@pytest.mark.parametrize("n,L,ansatz", STATE_CASES)
@pytest.mark.parametrize("d", [0, 2])
def test_state_matches_jax(n, L, ansatz, d, monkeypatch):
    """ψ(θ) (ψ(θ | x) for d > 0) on the circuit2d plain path against the
    JAX machine's state in complex128, with |ψ|² the port's probabilities."""
    monkeypatch.setattr(jborn, "jnp", F64Jnp())
    tm = QuantumBornMachine(n, L, ansatz, dtype=F64, device="cpu", conditioning_dim=d)
    jm = JQBM(n, ansatz_layers=L, ansatz_type=ansatz, conditioning_dim=d, dtype=jnp.complex128)
    assert tm.backend == "circuit2d"
    rng = np.random.default_rng(n * 10 + L)
    params = rng.uniform(0, 2 * np.pi, tm.num_params)
    for x in ([None] if d == 0 else [[1.0, 0.0], [0.0, 1.0]]):
        tx = None if x is None else torch.as_tensor(x, dtype=F64)
        jx = None if x is None else jnp.asarray(x, dtype=jnp.float64)
        st = tm.state(torch.as_tensor(params), tx)
        assert st.shape == (2,) * n and st.dtype == torch.complex128
        np.testing.assert_allclose(st.numpy(), np.asarray(jm.state(jnp.asarray(params), jx)),
                                   rtol=0, atol=1e-10)
        probs = tm.probs(torch.as_tensor(params), tx)
        np.testing.assert_allclose((st.abs() ** 2).reshape(-1).numpy(), probs.numpy(),
                                   rtol=0, atol=1e-12)


def test_state_on_the_grid_path_matches_jax():
    """n=18 resolves to circuit2d_grid; its plain version's final planes,
    re-indexed, against the JAX state."""
    n = 18
    tm = QuantumBornMachine(n, 1, dtype=F64, device="cpu")
    jm = JQBM(n, ansatz_layers=1, dtype=jnp.complex128)
    assert tm.backend == "circuit2d_grid"
    params = np.random.default_rng(18).uniform(0, 2 * np.pi, tm.num_params)
    st = tm.state(torch.as_tensor(params))
    want = np.asarray(jm.state(jnp.asarray(params)))
    np.testing.assert_allclose(st.numpy(), want, rtol=0, atol=1e-10)
    np.testing.assert_allclose((st.abs() ** 2).reshape(-1).numpy(),
                               tm.probs(torch.as_tensor(params)).numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("backend", ["blocked", "blocked2d", "einsum"])
def test_state_on_the_other_backends(backend):
    n, L = 4, 2
    tm = QuantumBornMachine(n, L, backend=backend, dtype=F64, device="cpu")
    ref = QuantumBornMachine(n, L, dtype=F64, device="cpu")
    params = torch.as_tensor(np.random.default_rng(4).uniform(0, 2 * np.pi, tm.num_params))
    np.testing.assert_allclose(tm.state(params).numpy(), ref.state(params).numpy(),
                               rtol=0, atol=1e-12)


def test_state_raises_for_bn_structured_and_checks_x():
    bn = get_random_chain_network(5, seed=0)
    edges = latent_edges(bn, [f"V{i}" for i in range(4)])
    tm = QuantumBornMachine(4, 2, "bn_structured", edges=edges, dtype=F64, device="cpu")
    with pytest.raises(NotImplementedError, match="probabilities only"):
        tm.state(tm.init(torch.Generator().manual_seed(0)))
    plain = QuantumBornMachine(3, 1, dtype=F64, device="cpu")
    p = plain.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="conditioning_dim is 0"):
        plain.state(p, torch.ones(1, dtype=F64))
    cond = QuantumBornMachine(3, 1, dtype=F64, device="cpu", conditioning_dim=1)
    with pytest.raises(ValueError, match="must be provided"):
        cond.state(cond.init(torch.Generator().manual_seed(0)))


def test_all_outcome_tuples_match_jax():
    tm = QuantumBornMachine(4, 1, device="cpu")
    assert tm.all_outcome_tuples == JQBM(4).all_outcome_tuples
    assert tm.all_outcome_tuples is tm.all_outcome_tuples  # built once
    assert list(tm.get_prob_dict(tm.init(torch.Generator().manual_seed(0)))) == \
        tm.all_outcome_tuples


def test_ksd_quantum_alias_module():
    from tensornetworks_tpu.engines import ksd_quantum as jalias
    from tensornetworks_tpu_torch.engines import ksd_quantum

    assert ksd_quantum.KSDVariationalInference is QuantumKSDVariationalInference
    assert ksd_quantum.__all__ == jalias.__all__
