"""The port's gcorr n+1-column Stein operator and tempered targets against
the JAX package: ``stein_matvec_gcorr_tables`` against JAX's three TPU
layouts of the correction (``corr`` = flips, matmul, folded), the derivation
form ``stein_matvec_gcorr``, ``kron_matvec_rows``, the recombination's plain
version against the 3n+1 oracle, the operator (matvec, quadratic form and
its gradient, lazy S and B, nothing launched on the CPU), the tempered
operator ``build_operator(temper_beta)``, and the engine and the scale
runner with ``temper_betas``.

Float64 on the CPU throughout; the tolerance is summation order: 1e-12
relative to the result's scale on the operator, 1e-9 relative on engine
histories (as in tests/test_torch_engine.py). The stein_gcorr CUDA kernel
itself runs only on the card, in chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensornetworks_tpu.core import all_bitstrings as j_all_bitstrings
from tensornetworks_tpu.core import get_random_chain_network as j_chain
from tensornetworks_tpu.engines.ksd import QuantumKSDVariationalInference as JEngine
from tensornetworks_tpu.models import QuantumBornMachine as JQBM
from tensornetworks_tpu.ops import kron as jkron
from tensornetworks_tpu.ops import stein as jstein
from tensornetworks_tpu.runners import scale as jscale
from tensornetworks_tpu_torch.core import get_random_chain_network as t_chain
from tensornetworks_tpu_torch.engines import QuantumKSDVariationalInference
from tensornetworks_tpu_torch.engines.ksd import run_ksd_scan
from tensornetworks_tpu_torch.engines.common import make_optimizer
from tensornetworks_tpu_torch.interop import params_from_jax, quantum_engine_with_params
from tensornetworks_tpu_torch.ops import kron as tkron
from tensornetworks_tpu_torch.ops import stein as tstein
from tensornetworks_tpu_torch.ops.hamming import decay_factor
from tensornetworks_tpu_torch.ops.kernels import _lib
from tensornetworks_tpu_torch.ops.kernels import stein_gcorr as tg
from tensornetworks_tpu_torch.runners import scale as tscale

F64 = torch.float64


def _score(n, seed=0):
    latent, obs = [f"V{i}" for i in range(n)], {f"V{n}": 1}
    return tstein.score_table(t_chain(n + 1, seed=seed).conditional_joint_table(latent, obs))


def _q(n, seed=1):
    q = np.random.default_rng(seed).random(2**n)
    return q / q.sum()


def _close(a, b, rel=1e-12):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=rel * np.abs(b).max())


@pytest.mark.parametrize("corr", ["flips", "matmul", "folded"])
@pytest.mark.parametrize("n", [13, 14, 15])
def test_gcorr_tables_matvec_matches_every_jax_correction_form(n, corr):
    """The port's one recombination against each TPU layout of it; the port
    applies K in the row layout, JAX in the two-sided split."""
    S, q, ls = _score(n, seed=n), _q(n), 1.0 / n
    matvec = jax.jit(jstein.stein_matvec_gcorr_tables, static_argnums=(2, 3, 4, 5, 6))
    y_j = matvec(jnp.asarray(q), jstein.make_gcorr_tables(jnp.asarray(S), n), n, ls, 7, "2d",
                 corr)
    tables = tstein.make_gcorr_tables(S, n, dtype=F64)
    _close(tstein.stein_matvec_gcorr_tables(torch.as_tensor(q), tables, n, ls, kron="rows"), y_j)


@pytest.mark.parametrize("kron", ["2d", "rows"])
@pytest.mark.parametrize("n", [5, 8])
def test_gcorr_tables_matvec_on_a_random_score(n, kron):
    """An arbitrary S (no network behind it) against JAX's gcorr form and the
    3n+1 oracle."""
    rng = np.random.default_rng(n)
    S, q = rng.normal(size=(2**n, n)), _q(n, seed=n)
    B = j_all_bitstrings(n).astype(np.float64)
    y_j = jstein.stein_matvec_gcorr_tables(jnp.asarray(q), jstein.make_gcorr_tables(
        jnp.asarray(S), n), n, 0.8, kron=kron)
    y_t = tstein.stein_matvec_gcorr_tables(torch.as_tensor(q),
                                           tstein.make_gcorr_tables(torch.as_tensor(S), n),
                                           n, 0.8, kron=kron)
    _close(y_t, y_j)
    _close(y_t, tstein.stein_matvec(torch.as_tensor(q), torch.as_tensor(S),
                                    torch.as_tensor(B), n, 0.8))
    with pytest.raises(ValueError, match="kron"):
        tstein.stein_matvec_gcorr_tables(torch.as_tensor(q), tstein.make_gcorr_tables(
            torch.as_tensor(S), n), n, 0.8, kron="dense")


@pytest.mark.parametrize("n,kron", [(5, "2d"), (8, "rows"), (13, "2d")])
def test_stein_matvec_gcorr_matches_jax(n, kron):
    S, q = _score(n), _q(n)
    B = j_all_bitstrings(n).astype(np.float64)
    matvec = jax.jit(jstein.stein_matvec_gcorr, static_argnums=(3, 4, 5, 6))
    y_j = matvec(jnp.asarray(q), jnp.asarray(S), jnp.asarray(B), n, 0.6, 7, kron)
    _close(tstein.stein_matvec_gcorr(torch.as_tensor(q), torch.as_tensor(S),
                                     torch.as_tensor(B), n, 0.6, kron=kron), y_j)


@pytest.mark.parametrize("n", [8, 14])
def test_kron_matvec_rows_matches_jax(n):
    A = np.array([[1.0, 0.45], [0.45, 1.0]])
    v = np.random.default_rng(n).normal(size=(3, 2**n))
    for group in (3, 7):
        assert tkron._group_plan_balanced(n, group) == jkron._group_plan_balanced(n, group)
        _close(tkron.kron_matvec_rows(torch.as_tensor(v), A, n, group=group),
               jkron.kron_matvec_rows(jnp.asarray(v), A, n, group=group))


@pytest.mark.parametrize("n", [4, 9])
def test_gcorr_combine_plain_matches_the_3n1_oracle(n):
    """The recombination from P0 = K q and Q = K(S∘q) is K_p q; on CPU
    tensors the wrapper is the plain version and launches nothing."""
    rng = np.random.default_rng(n)
    S, q, a = rng.normal(size=(2**n, n)), _q(n, seed=n), decay_factor(n, 0.3)
    K = jkron.kron_power_np(np.array([[1.0, a], [a, 1.0]]), n)
    St = torch.as_tensor(S.T.copy())
    P0, Q = torch.as_tensor(K @ q), torch.as_tensor((S.T * q) @ K.T)
    before = dict(_lib.LAUNCHES)
    y = tg.gcorr_combine(P0, Q, St, St.sum(dim=0), a, n)
    assert _lib.LAUNCHES == before
    assert torch.equal(y, tg.gcorr_combine_plain(P0, Q, St, St.sum(dim=0), a, n))
    B = j_all_bitstrings(n).astype(np.float64)
    _close(y, tstein.stein_matvec(torch.as_tensor(q), torch.as_tensor(S), torch.as_tensor(B),
                                  n, 0.3))


def test_flip_bit_is_the_msb_first_xor():
    n, x = 5, torch.arange(32.0)
    for t in range(n):
        assert tg.flip_bit(x, t, n).tolist() == [float(i ^ (1 << (n - 1 - t))) for i in range(32)]


def test_gcorr_combine_checks_its_operands():
    n = 4
    P0, Q = torch.zeros(16), torch.zeros((n, 16))
    for bad in (dict(n=1), dict(Q=torch.zeros((n, 8))), dict(Q=torch.zeros((n, 16), dtype=F64)),
                dict(Q=torch.zeros((16, n)).T)):
        args = dict(P0=P0, Q=Q, St=torch.zeros((n, 16)), Rv=torch.zeros(16), n=n) | bad
        with pytest.raises(ValueError, match="stein_gcorr"):
            tg._check(args["P0"], args["Q"], args["St"], args["Rv"], args["n"])


@pytest.mark.parametrize("n", [13, 14])
def test_operator_runs_the_gcorr_form_and_matches_jax(n):
    """The non-dense operator against JAX's (which runs its gcorr form with
    ``corr="flips"`` here): matvec, quadratic form and gradient. It builds
    neither S nor B, holds no (3n+1, 2^n) tensor and launches nothing on the
    CPU."""
    S, q, ls = _score(n, seed=2), _q(n, seed=3), 0.5
    before = dict(_lib.LAUNCHES)
    op_t = tstein.SteinOperator(S, n, ls, dtype=F64, device="cpu")
    op_j = jstein.SteinOperator(S, n, ls, dtype=jnp.float64)
    assert not op_t.dense and op_j.gcorr is not None
    _close(op_t.matvec(torch.as_tensor(q)), op_j.matvec(jnp.asarray(q)))
    qt = torch.as_tensor(q).requires_grad_(True)
    qf_t = op_t.quadform(qt)
    (g_t,) = torch.autograd.grad(qf_t, qt)
    qf_j, g_j = jax.value_and_grad(op_j.quadform)(jnp.asarray(q))
    np.testing.assert_allclose(float(qf_t.detach()), float(qf_j), rtol=1e-12)
    _close(g_t, g_j)
    assert _lib.LAUNCHES == before
    assert op_t._S is None and op_t._B is None
    held = [t for t in list(vars(op_t).values()) + list(op_t.gcorr) if torch.is_tensor(t)]
    assert held and all(t.shape[0] != 3 * n + 1 for t in held)
    assert sum(t.numel() for t in held) == (n + 1) * 2**n
    # S and B are built when touched, and then the 3n+1 oracle agrees.
    _close(tstein.stein_matvec(torch.as_tensor(q), op_t.S, op_t.B, n, ls),
           op_t.matvec(torch.as_tensor(q)))
    assert op_t.S is op_t._S and op_t.S.dtype == F64


def test_ksd_quadform_gcorr_gradcheck():
    n = 5
    tables = tstein.make_gcorr_tables(torch.as_tensor(_score(n)), n)
    q = torch.as_tensor(_q(n)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda v: tstein.ksd_quadform_gcorr(v, tables, n, 0.7, kron="2d"), (q,))


def _jax_engine(n, L, theta):
    latent, obs = [f"V{i}" for i in range(n)], {f"V{n}": 1}
    jeng = JEngine(j_chain(n + 1, seed=0), latent, list(obs), qbm_num_latent_vars=n,
                   qbm_ansatz_layers=L, dtype=jnp.float64)
    jeng.born_machine = JQBM(n, ansatz_layers=L, dtype=jnp.complex128)
    jeng.params = jnp.asarray(theta)
    teng = quantum_engine_with_params(theta, t_chain(n + 1, seed=0), latent, list(obs),
                                      qbm_ansatz_layers=L, dtype=F64, device="cpu")
    return jeng, teng, obs, t_chain(n + 1, seed=0).posterior_vector(latent, obs)


@pytest.mark.parametrize("n", [6, 13])  # dense Gram / gcorr form
def test_build_operator_tempered_matches_jax(n):
    theta = 0.1 * np.random.default_rng(n).normal(size=3 * n)
    jeng, teng, obs, _ = _jax_engine(n, 1, theta)
    q = _q(n, seed=n)
    op_t = teng.build_operator(obs, temper_beta=0.5)
    op_j = jeng.build_operator(obs, temper_beta=0.5)
    assert op_t.dense == (n <= 12)
    y_t = op_t.matvec(torch.as_tensor(q))
    _close(y_t, op_j.matvec(jnp.asarray(q)))
    # β = 0.5 is another target than β = 1.
    untempered = teng.build_operator(obs).matvec(torch.as_tensor(q))
    assert float((y_t - untempered).abs().max()) > 1e-3 * float(untempered.abs().max())


def test_tempered_engine_history_matches_jax():
    """β = 0.5 for chunk 0, then 1.0 (held past the list's end), from a
    shared θ; the TVD is against the untempered posterior in both."""
    n, L = 6, 2
    theta = 0.1 * np.random.default_rng(7).normal(size=3 * L * n)
    jeng, teng, obs, post = _jax_engine(n, L, theta)
    kw = dict(num_epochs=6, lr_born_machine=0.05, verbose=False, true_posterior_for_tvd=post,
              chunk_epochs=2, temper_betas=[0.5, 1.0])
    hj, ht = jeng.train(obs, **kw), teng.train(obs, **kw)
    for key in ("loss_ksd", "tvd", "grad_norm"):
        np.testing.assert_allclose(ht[key], hj[key], rtol=1e-9, err_msg=key)
    assert teng.best_tvd_ == pytest.approx(jeng.best_tvd_, rel=1e-9)
    assert teng.best_epoch_ == jeng.best_epoch_


def test_temper_betas_of_one_equal_the_untempered_run():
    n, L = 6, 2
    theta = 0.1 * np.random.default_rng(8).normal(size=3 * L * n)
    runs = []
    for betas in (None, [1.0]):
        _, teng, obs, post = _jax_engine(n, L, theta)
        built = []
        build = teng.build_operator
        teng.build_operator = lambda x, temper_beta=1.0: built.append(temper_beta) or build(
            x, temper_beta)
        runs.append(teng.train(obs, num_epochs=6, lr_born_machine=0.05, verbose=False,
                               true_posterior_for_tvd=post, chunk_epochs=2,
                               temper_betas=betas))
        assert built == [1.0]  # β = 1.0 reuses the untempered operator
    for key in ("loss_ksd", "tvd", "grad_norm"):
        assert runs[0][key] == runs[1][key], key


def test_temper_betas_need_chunk_epochs():
    n = 4
    _, teng, obs, _ = _jax_engine(n, 1, np.zeros(3 * n))
    with pytest.raises(ValueError, match="chunk_epochs"):
        teng.train(obs, num_epochs=2, lr_born_machine=0.05, verbose=False, temper_betas=[0.5])
    op = teng.build_operator(obs)
    with pytest.raises(ValueError, match="chunk_epochs"):
        run_ksd_scan(probs_fn=teng.born_machine.probs, params0=teng.params, op=op,
                     num_epochs=2, optimizer=make_optimizer("adam", 0.05, 2),
                     posterior_vec=None, op_schedule=lambda i: op)


def test_scale_runner_tempered_matches_the_jax_runner(monkeypatch):
    """``run_scale_experiment(6, temper_betas=[0.5, 1.0])`` against the JAX
    runner, both engines in float64 from the same θ."""
    n, L = 6, 2
    theta = 0.2 * np.random.default_rng(6).normal(size=3 * L * n)

    class J(JEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, dtype=jnp.float64, **kw)
            self.born_machine = JQBM(n, ansatz_layers=L, dtype=jnp.complex128)
            self.params = jnp.asarray(theta)

    class T(QuantumKSDVariationalInference):
        def __init__(self, *a, **kw):
            super().__init__(*a, dtype=F64, **kw)
            self.params = params_from_jax(theta, device="cpu", dtype=F64)

    monkeypatch.setattr(jscale, "QuantumKSDVariationalInference", J)
    monkeypatch.setattr(tscale, "QuantumKSDVariationalInference", T)
    kw = dict(num_qubits=n, layers=L, num_epochs=6, lr=0.05, chunk_epochs=2,
              temper_betas=[0.5, 1.0], seed=1, verbose=False)
    jout = jscale.run_scale_experiment(**kw)
    tout = tscale.run_scale_experiment(device="cpu", **kw)
    for key in ("loss_ksd", "tvd", "grad_norm"):
        np.testing.assert_allclose(tout["history"][key], jout["history"][key], rtol=1e-9,
                                   err_msg=key)
    assert tout["model"].best_tvd_ == pytest.approx(jout["model"].best_tvd_, rel=1e-9)
