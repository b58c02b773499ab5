"""The port's sampled-KSD slice against the JAX package: the factored log
joints, the sample scores and Gram, the U/V statistics, the REINFORCE
surrogates with their baselines and the control variate (with the CG
solve), the samplers on the JAX package's own uniforms, ``gather_2d``, and
the Born machines' ``log_probs``, ``log_q`` and ``sample``.

Float64 on the CPU, tolerance 1e-12 (absolute, or relative to the largest
magnitude where the values are large), unless a test says otherwise. The
samplers take their uniforms as arguments; the tests draw them with
``jax.random.uniform`` from the JAX functions' own keys, so both packages
must return identical indices.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensornetworks_tpu.core.bayes_net import BayesianNetwork as JBN
from tensornetworks_tpu.core import factors as jfactors
from tensornetworks_tpu.models import ClassicalBornMachine as JCBM
from tensornetworks_tpu.models import QuantumBornMachine as JQBM
from tensornetworks_tpu.ops import stein_sampled as jss
from tensornetworks_tpu.sim import sampling as jsampling
from tensornetworks_tpu_torch.core import BayesianNetwork, all_bitstrings, get_random_chain_network
from tensornetworks_tpu_torch.core import factors
from tensornetworks_tpu_torch.interop import flat_from_flax, params_from_jax
from tensornetworks_tpu_torch.models import ClassicalBornMachine, QuantumBornMachine
from tensornetworks_tpu_torch.ops import stein_sampled as ss
from tensornetworks_tpu_torch.ops.stein import SteinOperator, score_table, stein_gram_dense
from tensornetworks_tpu_torch.sim import sampling

F64 = torch.float64
TOL = 1e-12


def _t(a):
    return torch.as_tensor(np.array(a))


def _zero_cpt_networks():
    """A, B, C latent and X observed, with zero CPT entries: p(B=1|A=1) = 0
    and p(X=1|B=0,C=1) = 0, so some latent states have p(x, z) = 0."""
    nets = []
    for cls in (BayesianNetwork, JBN):
        bn = cls()
        bn.add_node("A", cpt={(): {0: 0.4, 1: 0.6}})
        bn.add_node("B", cpt={(0,): {0: 0.3, 1: 0.7}, (1,): {0: 1.0, 1: 0.0}},
                    parent_names=["A"])
        bn.add_node("C", cpt={(0,): {0: 0.8, 1: 0.2}, (1,): {0: 0.25, 1: 0.75}},
                    parent_names=["B"])
        bn.add_node("X", cpt={(0, 0): {0: 0.9, 1: 0.1}, (0, 1): {0: 1.0, 1: 0.0},
                              (1, 0): {0: 0.5, 1: 0.5}, (1, 1): {0: 0.35, 1: 0.65}},
                    parent_names=["B", "C"])
        nets.append(bn)
    return nets


LATENT, OBS = ["A", "B", "C"], {"X": 1}


def test_compile_factors_and_log_joints_match_jax():
    tbn, jbn = _zero_cpt_networks()
    for t, j in zip(factors.compile_factors(tbn), jfactors.compile_factors(jbn)):
        np.testing.assert_array_equal(t, j)
    assert factors.LOG_FLOOR == jfactors.LOG_FLOOR
    assign = all_bitstrings(4, np.int64)
    t_lj = factors.make_log_joint_fn(tbn, dtype=F64, device="cpu")(_t(assign))
    j_lj = jfactors.make_log_joint_fn(jbn, dtype=jnp.float64)(jnp.asarray(assign))
    np.testing.assert_allclose(t_lj.numpy(), np.asarray(j_lj), rtol=TOL, atol=TOL)
    assert (t_lj.numpy() < -600).any()  # the floored zero entries
    z = all_bitstrings(3, np.int64)
    t_lat = factors.make_latent_log_joint_fn(tbn, LATENT, OBS, dtype=F64, device="cpu")
    j_lat = jfactors.make_latent_log_joint_fn(jbn, LATENT, OBS, dtype=jnp.float64)
    np.testing.assert_allclose(t_lat(_t(z)).numpy(), np.asarray(j_lat(jnp.asarray(z))),
                               rtol=TOL, atol=TOL)
    # A batch of (M, n, n) flips, as the score evaluates it.
    zz = np.broadcast_to(z[:, None, :], (8, 3, 3))
    np.testing.assert_allclose(t_lat(_t(zz.copy())).numpy(), np.asarray(j_lat(jnp.asarray(zz))),
                               rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="unassigned"):
        factors.make_latent_log_joint_fn(tbn, ["A", "B"], OBS, device="cpu")


def test_score_at_samples_matches_jax_with_guarded_rows():
    tbn, jbn = _zero_cpt_networks()
    t_lat = factors.make_latent_log_joint_fn(tbn, LATENT, OBS, dtype=F64, device="cpu")
    j_lat = jfactors.make_latent_log_joint_fn(jbn, LATENT, OBS, dtype=jnp.float64)
    Z = np.concatenate([all_bitstrings(3, np.int64),
                        np.random.default_rng(0).integers(0, 2, size=(9, 3))])
    s_t = ss.score_at_samples(t_lat, _t(Z)).numpy()
    s_j = np.asarray(jss.score_at_samples(j_lat, jnp.asarray(Z)))
    np.testing.assert_allclose(s_t, s_j, rtol=TOL, atol=TOL)
    guarded = (s_t == 0).all(axis=1)
    assert guarded.any() and not guarded.all()
    # The full enumeration's rows are the dense score table's.
    np.testing.assert_allclose(s_t[:8], score_table(tbn.conditional_joint_table(LATENT, OBS)),
                               rtol=TOL, atol=TOL)


def _chain_problem(n, seed=1):
    bn = get_random_chain_network(n + 1, seed=seed)
    latent = [f"V{i}" for i in range(n)]
    obs = {f"V{n}": 1}
    return bn, latent, obs, score_table(bn.conditional_joint_table(latent, obs))


@pytest.mark.parametrize("ls", [1.0, 0.2])
def test_stein_gram_samples_matches_jax_and_the_dense_gram(ls):
    n = 5
    _, _, _, S = _chain_problem(n)
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 2**n, size=23)
    X = all_bitstrings(n, np.float64)[idx]
    g_t = ss.stein_gram_samples(_t(S[idx]), _t(X), n, ls)
    g_j = np.asarray(jss.stein_gram_samples(jnp.asarray(S[idx]), jnp.asarray(X), n, ls))
    scale = np.abs(g_j).max()
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=TOL * scale)
    full = ss.stein_gram_samples(_t(S), _t(all_bitstrings(n, np.float64)), n, ls)
    dense = stein_gram_dense(_t(S), n, ls)
    np.testing.assert_allclose(full.numpy(), dense.numpy(), rtol=0,
                               atol=TOL * dense.abs().max().item())


def test_ksd_statistics_match_jax():
    g = np.random.default_rng(0).normal(size=(7, 7))
    g = g + g.T
    for fn in ("ksd_ustat", "ksd_vstat"):
        assert float(getattr(ss, fn)(_t(g))) == pytest.approx(
            float(getattr(jss, fn)(jnp.asarray(g))), abs=TOL)
    two = _t([[4.0, 1.0], [3.0, 2.0]])
    assert float(ss.ksd_ustat(two)) == 2.0 and float(ss.ksd_vstat(two)) == 2.5


def _surrogate_case(M, seed=0, K=16):
    """A symmetric Gram over M samples, their indices into K logits, and the
    logits: log q = log_softmax(logits)[idx]."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(M, M))
    return g + g.T, rng.integers(0, K, size=M), rng.normal(size=K)


@pytest.mark.parametrize("baseline,M", [("loo", 9), ("mean", 9), ("none", 9), ("loo", 2),
                                        ("mean", 2)])
def test_reinforce_surrogate_gradient_matches_jax(baseline, M):
    g, idx, logits = _surrogate_case(M)
    p = _t(logits).requires_grad_(True)
    val_t = ss.reinforce_surrogate(_t(g), torch.log_softmax(p, 0)[_t(idx)], baseline)
    val_t.backward()

    def jfun(lg):
        return jss.reinforce_surrogate(jnp.asarray(g), jax.nn.log_softmax(lg)[idx], baseline)

    val_j, grad_j = jax.value_and_grad(jfun)(jnp.asarray(logits))
    assert float(val_t.detach()) == pytest.approx(float(val_j), abs=TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(grad_j), rtol=0, atol=TOL)
    if M == 2 and baseline == "loo":  # no pairs exclude a sample: "none"
        plain = ss.reinforce_surrogate(_t(g), torch.log_softmax(_t(logits), 0)[_t(idx)], "none")
        assert float(plain) == pytest.approx(float(val_t.detach()), abs=TOL)


def test_reinforce_surrogate_rejects_an_unknown_baseline():
    g, idx, logits = _surrogate_case(4)
    with pytest.raises(ValueError, match="loo|mean|none"):
        ss.reinforce_surrogate(_t(g), _t(logits)[_t(idx)], "median")


def test_cg_control_variate_and_cv_surrogate_match_jax():
    rng = np.random.default_rng(5)
    n, M = 6, 40
    A = rng.normal(size=(n, n))
    A = A @ A.T + 0.1 * np.eye(n)
    b = rng.normal(size=n)
    np.testing.assert_allclose(ss._cg_solve(_t(A), _t(b), 2 * n).numpy(),
                               np.asarray(jss._cg_solve(jnp.asarray(A), jnp.asarray(b), 2 * n)),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(ss._cg_solve(_t(A), _t(b), 2 * n).numpy(), np.linalg.solve(A, b),
                               rtol=1e-9)
    Z = rng.integers(0, 2, size=(M, n)).astype(np.float64)
    Z[:, 2] = 1.0  # a constant bit column
    w = Z @ rng.normal(size=n) + 0.01 * rng.normal(size=M)
    for t, j in zip(ss.fit_linear_control_variate(_t(w), _t(Z)),
                    jss.fit_linear_control_variate(jnp.asarray(w), jnp.asarray(Z))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-10)
    g, _, _ = _surrogate_case(M, seed=6)
    idx = rng.integers(0, 2**n, size=M)
    Z = all_bitstrings(n, np.float64)[idx]
    logits = rng.normal(size=2**n)
    B = all_bitstrings(n, np.float64)
    p = _t(logits).requires_grad_(True)
    q = torch.softmax(p, 0)
    val_t = ss.reinforce_surrogate_cv(_t(g), torch.log(q)[_t(idx)], _t(Z), q @ _t(B))
    val_t.backward()

    def jfun(lg):
        qj = jax.nn.softmax(lg)
        return jss.reinforce_surrogate_cv(jnp.asarray(g), jnp.log(qj)[idx], jnp.asarray(Z),
                                          qj @ jnp.asarray(B))

    val_j, grad_j = jax.value_and_grad(jfun)(jnp.asarray(logits))
    assert float(val_t.detach()) == pytest.approx(float(val_j), abs=1e-10)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(grad_j), rtol=0, atol=1e-10)


def test_weighted_surrogate_gradient_is_the_exact_quadform_gradient():
    """On the full enumeration, weighted by q, the surrogate's gradient is
    ∇(qᵀ K_p q) of the port's ``SteinOperator`` (and of JAX's surrogate)."""
    n = 5
    _, _, _, S = _chain_problem(n)
    op = SteinOperator(S, n, 0.5, dtype=F64, device="cpu")
    logits = np.random.default_rng(0).normal(size=2**n)
    gram = ss.stein_gram_samples(_t(S), _t(all_bitstrings(n, np.float64)), n, 0.5)
    grads = []
    for exact in (True, False):
        p = _t(logits).requires_grad_(True)
        q = torch.softmax(p, 0)
        val = (op.quadform(q) if exact
               else ss.reinforce_surrogate_weighted(gram, torch.log_softmax(p, 0), q))
        val.backward()
        grads.append(p.grad.numpy())
    scale = np.abs(grads[0]).max()
    np.testing.assert_allclose(grads[1], grads[0], rtol=0, atol=1e-10 * scale)
    jgram = jnp.asarray(gram.numpy())
    g_j = jax.grad(lambda lg: jss.reinforce_surrogate_weighted(
        jgram, jax.nn.log_softmax(lg), jax.nn.softmax(lg)))(jnp.asarray(logits))
    np.testing.assert_allclose(grads[1], np.asarray(g_j), rtol=0, atol=TOL * scale)


def _probs(size, seed, spiky=False):
    p = np.random.default_rng(seed).random(size) ** (8 if spiky else 1)
    if spiky:
        p[::7] = 0.0  # zero outcomes: only the smoothing reaches them
    return p / p.sum(axis=-1, keepdims=True)


@pytest.mark.parametrize("spiky", [False, True])
def test_sample_indices_replays_jax_uniforms(spiky):
    M = 5000
    key = jax.random.PRNGKey(7)
    for size in (sampling.CDF_SAMPLING_MIN_SIZE, 8192):
        probs = _probs(size, size, spiky)
        want = np.asarray(jsampling.sample_indices(key, jnp.asarray(probs), M))
        u = np.asarray(jax.random.uniform(key, (M,), dtype=jnp.float64))
        got = sampling.sample_indices(_t(probs), _t(u)).numpy()
        np.testing.assert_array_equal(got, want)
        bits = sampling.sample_bits(_t(probs), _t(u), 13, dtype=F64).numpy()
        np.testing.assert_array_equal(
            bits, np.asarray(jsampling.sample_bits(key, jnp.asarray(probs), M, 13,
                                                   dtype=jnp.float64)))


@pytest.mark.parametrize("shape,spiky", [((32, 16), False), ((64, 128), True), ((2, 2), False)])
def test_sample_indices_2d_replays_jax_uniforms(shape, spiky):
    M = 3000
    key = jax.random.PRNGKey(11)
    P = _probs(shape[0] * shape[1], 1, spiky).reshape(shape)
    flat_j, r_j, c_j = jsampling.sample_indices_2d(key, jnp.asarray(P), M)
    key_r, key_c = jax.random.split(key)
    u_r = np.asarray(jax.random.uniform(key_r, (M,), dtype=jnp.float64))
    u_c = np.asarray(jax.random.uniform(key_c, (M,), dtype=jnp.float64))
    flat_t, r_t, c_t = sampling.sample_indices_2d(_t(P), _t(u_r), _t(u_c))
    for t, j in ((flat_t, flat_j), (r_t, r_j), (c_t, c_j)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if spiky:  # the zero outcomes are drawn only through the smoothing
        assert not np.isin(flat_t.numpy(), np.flatnonzero(P.reshape(-1) == 0)).any()


def test_two_stage_and_flat_sampling_draw_the_same_distribution():
    P = _probs(64, 2).reshape(8, 8)
    gen = torch.Generator().manual_seed(0)
    flat, _, _ = sampling.inverse_cdf_sampler(_t(P), 200_000, gen)
    emp = np.bincount(flat.numpy(), minlength=64) / 200_000
    assert 0.5 * np.abs(emp - P.reshape(-1)).sum() < 0.01
    idx = sampling.inverse_cdf_sampler(_t(P.reshape(-1)), 200_000, gen)
    emp = np.bincount(idx.numpy(), minlength=64) / 200_000
    assert 0.5 * np.abs(emp - P.reshape(-1)).sum() < 0.01


def test_gather_2d_and_its_gradient_match_jax():
    rng = np.random.default_rng(0)
    P = rng.random((8, 16))
    r, c = rng.integers(0, 8, size=40), rng.integers(0, 16, size=40)
    w = rng.normal(size=40)
    Pt = _t(P).requires_grad_(True)
    out = sampling.gather_2d(Pt, _t(r), _t(c))
    (out * _t(w)).sum().backward()
    val_j, grad_j = jax.value_and_grad(
        lambda X: (jsampling.gather_2d(X, jnp.asarray(r), jnp.asarray(c)) * w).sum())(
            jnp.asarray(P))
    np.testing.assert_array_equal(out.detach().numpy(), P[r, c])
    assert float((out * _t(w)).sum().detach()) == pytest.approx(float(val_j), abs=TOL)
    np.testing.assert_allclose(Pt.grad.numpy(), np.asarray(grad_j), rtol=0, atol=TOL)


def test_parameter_shift_jacobian_matches_autograd():
    qbm = QuantumBornMachine(3, 2, dtype=F64, device="cpu")
    theta = _t(np.random.default_rng(0).normal(size=qbm.num_params))
    jac = sampling.parameter_shift_jacobian(qbm.probs, theta)
    auto = torch.autograd.functional.jacobian(qbm.probs, theta)
    np.testing.assert_allclose(jac.numpy(), auto.numpy(), rtol=0, atol=TOL)


def _empirical_tvd(bits, probs):
    idx = (bits.numpy().astype(np.int64) * (1 << np.arange(bits.shape[-1] - 1, -1, -1))).sum(-1)
    emp = np.bincount(idx.reshape(-1), minlength=probs.shape[-1]) / idx.size
    return 0.5 * np.abs(emp - probs).sum()


@pytest.mark.parametrize("ansatz,n,layers", [("hardware_efficient", 4, 2), ("basic", 3, 3)])
def test_quantum_born_machine_log_q_and_sample(ansatz, n, layers):
    jq = JQBM(n, ansatz_layers=layers, ansatz_type=ansatz, dtype=jnp.complex128)
    tq = QuantumBornMachine(n, layers, ansatz, dtype=F64, device="cpu")
    theta = np.random.default_rng(n).normal(size=tq.num_params)
    tp = params_from_jax(theta, device="cpu", dtype=F64)
    jp = jnp.asarray(theta)
    np.testing.assert_allclose(tq.log_probs(tp).numpy(), np.asarray(jq.log_probs(jp)),
                               rtol=0, atol=TOL)
    z = all_bitstrings(n, np.float64)[np.random.default_rng(1).integers(0, 2**n, size=17)]
    np.testing.assert_allclose(tq.log_q(tp, _t(z)).numpy(),
                               np.asarray(jq.log_q(jp, jnp.asarray(z))), rtol=0, atol=TOL)
    bits = tq.sample(torch.Generator().manual_seed(0), tp, 100_000)
    assert bits.shape == (100_000, n) and bits.dtype == torch.float32
    assert _empirical_tvd(bits, tq.probs(tp).numpy()) < 0.01


@pytest.mark.parametrize("conditioned", [False, True])
def test_classical_born_machine_log_q_and_sample(conditioned):
    n, d = 3, 2
    kw = {"conditioning_dim": d, "dropout_rate": 0.0} if conditioned else {}
    jc = JCBM(n, dtype=jnp.float64, **kw)
    tc = ClassicalBornMachine(n, dtype=F64, device="cpu", **kw)
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float64) + 0.3 * rng.normal(size=a.shape),
                           jc.init(jax.random.PRNGKey(0)))
    tp = flat_from_flax(jparams, tc.layout, "cpu", F64)
    jp = jax.tree.map(jnp.asarray, jparams)
    x = np.array([[0.0, 1.0], [1.0, 1.0], [1.0, 0.0]]) if conditioned else None
    z = all_bitstrings(n, np.float64)[[1, 6, 3]] if conditioned else \
        all_bitstrings(n, np.float64)[rng.integers(0, 2**n, size=11)]
    xt = None if x is None else _t(x)
    xj = None if x is None else jnp.asarray(x)
    np.testing.assert_allclose(tc.log_probs(tp, xt).numpy(), np.asarray(jc.log_probs(jp, xj)),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tc.log_q(tp, _t(z), xt).numpy(),
                               np.asarray(jc.log_q(jp, jnp.asarray(z), xj)), rtol=0, atol=TOL)
    bits = tc.sample(torch.Generator().manual_seed(1), tp, 100_000, xt)
    probs = tc.probs(tp, xt).detach().numpy()
    if conditioned:  # (M, B, n): one distribution per condition row
        assert bits.shape == (100_000, 3, n)
        for b in range(3):
            assert _empirical_tvd(bits[:, b], probs[b]) < 0.01
    else:
        assert bits.shape == (100_000, n)
        assert _empirical_tvd(bits, probs) < 0.01
