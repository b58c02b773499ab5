"""The port's training scaffolding and quantum KSD engine against the JAX
package: optimizer steps against optax, the skipped non-finite step, and
30-epoch engine histories from a shared θ at n=10 (dense Stein Gram) and
n=13 (the Kronecker path, which runs the stein2d kernel's plain version).

The port runs in float64 on the CPU; the JAX engine runs its Stein operator
in float64 with a complex128 Born machine, so both take the same steps up
to summation order. Tolerances: 1e-12 on single optimizer steps, 1e-9
relative on 30-epoch loss and TVD histories, 1e-7 on the restored θ (Adam's
normalisation amplifies round-off in near-zero gradient components)."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tensornetworks_tpu.core import get_random_chain_network as j_chain
from tensornetworks_tpu.engines import common as jcommon
from tensornetworks_tpu.engines.ksd import QuantumKSDVariationalInference as JEngine
from tensornetworks_tpu.models import QuantumBornMachine as JQBM
from tensornetworks_tpu_torch.core import get_random_chain_network as t_chain
from tensornetworks_tpu_torch.core import get_sprinkler_network
from tensornetworks_tpu_torch.engines import common as tcommon
from tensornetworks_tpu_torch.engines.ksd import run_ksd_scan
from tensornetworks_tpu_torch.interop import params_from_jax, quantum_engine_with_params
from tensornetworks_tpu_torch.models import QuantumBornMachine
from tensornetworks_tpu_torch.ops.stein import SteinOperator, score_table

F64 = torch.float64


@pytest.mark.parametrize("kind,sched,clip", [("adam", True, 10.0), ("adam", False, 0.05),
                                             ("sgd", True, None), ("other", True, 1.0)])
def test_optimizer_steps_match_optax(kind, sched, clip):
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=7)
    opt_j = jcommon.make_optimizer(kind, 0.1, 5, sched, (0.8, 0.95), clip)
    opt_t = tcommon.make_optimizer(kind, 0.1, 5, sched, (0.8, 0.95), clip)
    pj, sj = jnp.asarray(p0), opt_j.init(jnp.asarray(p0))
    pt = torch.as_tensor(p0)
    st = opt_t.init(pt)
    for step in range(8):  # past the schedule's end: it holds at lr/10
        g = rng.normal(size=7) * (3.0 if step % 2 else 0.01)
        upd, sj = opt_j.update(jnp.asarray(g), sj, pj)
        pj = optax.apply_updates(pj, upd)
        pt, st = opt_t.update(torch.as_tensor(g), st, pt)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-12)


def test_cosine_schedule_matches_jax():
    s_j = jcommon.cosine_lr_schedule(0.2, 7)
    s_t = tcommon.cosine_lr_schedule(0.2, 7)
    for c in range(10):
        assert abs(float(s_t(torch.tensor(c))) - float(s_j(c))) < 1e-15


def test_guarded_update_skips_everything():
    opt = tcommon.make_optimizer("adam", 0.1, 10)
    p = torch.ones(3, dtype=F64)
    st = opt.init(p)
    p1, st1 = tcommon.guarded_update(opt, torch.full_like(p, 0.5), st, p, torch.tensor(True))
    p2, st2 = tcommon.guarded_update(opt, torch.full_like(p, float("nan")), st1, p1,
                                     torch.tensor(False))
    assert int(st1["count"]) == 1 and int(st2["count"]) == 1
    assert torch.equal(p2, p1)
    for k in st1:
        assert torch.equal(st2[k], st1[k])
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
    assert float(tcommon.global_norm(g)) == 13.0


def test_non_finite_loss_skips_update_and_schedule_step():
    """A NaN loss at epoch 3 of 6 leaves θ, the Adam moments and the step
    count as they were: the run ends exactly where a 5-epoch run on the same
    6-epoch schedule ends, with one skipped step recorded."""
    bn = get_sprinkler_network()
    latent, obs = ["C", "S", "R"], {"W": 1}
    post = torch.as_tensor(bn.posterior_vector(latent, obs))
    op = SteinOperator(score_table(bn.conditional_joint_table(latent, obs)), 3,
                       dtype=F64, device="cpu")
    qbm = QuantumBornMachine(3, 2, dtype=F64, device="cpu")
    theta = qbm.init(torch.Generator().manual_seed(1))
    calls = []

    def poisoned(p):
        calls.append(None)
        q = qbm.probs(p)
        return q * float("nan") if len(calls) == 4 else q

    def run(probs_fn, epochs):
        return run_ksd_scan(probs_fn=probs_fn, params0=theta, op=op, num_epochs=epochs,
                            optimizer=tcommon.make_optimizer("adam", 0.05, 6),
                            posterior_vec=post)

    hit, clean = run(poisoned, 6), run(qbm.probs, 5)
    assert hit["skipped"].tolist() == [0, 0, 0, 1, 0, 0]
    assert np.isnan(hit["loss_ksd"][3])
    torch.testing.assert_close(hit["params"], clean["params"], rtol=0, atol=1e-14)
    np.testing.assert_allclose(np.delete(hit["loss_ksd"], 3), clean["loss_ksd"], atol=1e-14)
    assert hit["best_tvd"] == pytest.approx(clean["best_tvd"], abs=1e-14)


def _engines(n, L, theta):
    latent, obs = [f"V{i}" for i in range(n)], {f"V{n}": 1}
    jeng = JEngine(j_chain(n + 1, seed=0), latent, list(obs), qbm_num_latent_vars=n,
                   qbm_ansatz_layers=L, dtype=jnp.float64)
    jeng.born_machine = JQBM(n, ansatz_layers=L, dtype=jnp.complex128)
    jeng.params = jnp.asarray(theta)
    teng = quantum_engine_with_params(theta, t_chain(n + 1, seed=0), latent, list(obs),
                                      qbm_ansatz_layers=L, dtype=F64, device="cpu",
                                      qbm_backend="circuit2d")
    return jeng, teng, obs, t_chain(n + 1, seed=0).posterior_vector(latent, obs)


@pytest.mark.parametrize("n", [10, 13])  # dense Gram / Kronecker path with stein2d
def test_engine_history_matches_jax(n):
    L, epochs = 2, 30
    theta = 0.1 * np.random.default_rng(n).normal(size=3 * L * n)
    jeng, teng, obs, post = _engines(n, L, theta)
    assert teng.born_machine.backend == "circuit2d"
    kw = dict(num_epochs=epochs, lr_born_machine=0.05, verbose=False,
              true_posterior_for_tvd=post)
    hj = jeng.train(obs, **kw)
    ht = teng.train(obs, chunk_epochs=7, **kw)
    for key in ("loss_ksd", "tvd", "grad_norm"):
        np.testing.assert_allclose(ht[key], hj[key], rtol=1e-9, err_msg=key)
    assert teng.best_tvd_ == pytest.approx(jeng.best_tvd_, rel=1e-9)
    assert teng.best_epoch_ == jeng.best_epoch_
    np.testing.assert_allclose(teng.params.numpy(), np.asarray(jeng.params), atol=1e-7)
    assert ht["num_skipped_updates"] == 0 and "epochs_per_sec_steady" in ht
    assert ht["loss_ksd"][-1] < ht["loss_ksd"][0]


def test_params_from_jax_validates():
    t = params_from_jax(np.arange(6.0), device="cpu", dtype=F64)
    assert t.dtype == F64 and t.tolist() == list(range(6))
    with pytest.raises(ValueError):
        params_from_jax(np.zeros((2, 3)), device="cpu")
    with pytest.raises(ValueError):
        quantum_engine_with_params(np.zeros(5), get_sprinkler_network(), ["C", "S", "R"],
                                   ["W"], device="cpu")
