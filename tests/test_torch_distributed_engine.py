"""The distributed quantum-KSD engine (``engines/distributed.py``) and the
distributed scale runner against the JAX package, after its
tests/test_distributed_engine.py.

One spawn of 4 gloo ranks on the CPU runs every case. The JAX references
run in the pytest process through its single-device functions
(``run_ksd_scan`` with ``ansatz_probs``, ``make_structured_probs_fn``,
``SteinOperator``), to which its own tests pin its distributed engine. The
engine's histories over 25 epochs in float64 are held to 1e-9 (relative),
the circuits to 1e-12. The JAX spec's 20-qubit memory case runs at 14
qubits here (the same per-rank shapes, 2^n/D rows)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tensornetworks_tpu.core import get_random_chain_network
from tensornetworks_tpu.engines.common import make_optimizer
from tensornetworks_tpu.engines.ksd import run_ksd_scan
from tensornetworks_tpu.ops import SteinOperator, score_table
from tensornetworks_tpu.sim import ansatz_probs, num_ansatz_params
from tensornetworks_tpu.sim.structured import latent_edges, make_structured_probs_fn
from tensornetworks_tpu_torch.parallel import spawn

import torch_dist_ranks


def _problem(n, seed=0):
    bn = get_random_chain_network(n + 1, seed=seed)
    return bn, [f"V{i}" for i in range(n)], {f"V{n}": 1}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(0)
    inp = {"theta6": 0.1 * rng.normal(size=num_ansatz_params(6, 2, "hardware_efficient")),
           "theta_bn": 0.2 * rng.normal(size=3 * 3 * 6), "angles": rng.normal(size=6),
           "resume_path": str(tmp_path_factory.mktemp("resume") / "state.pt")}
    out = spawn(torch_dist_ranks.engine_cases, 4, "gloo", "cpu", inp, timeout_s=150)
    return inp, out


@pytest.mark.parametrize("shards", (4, 2))
def test_distributed_engine_matches_single_device_scan(case, shards):
    """Engine ``train`` (float64) against the JAX ``run_ksd_scan`` with the
    single-device executor: loss and TVD histories and the best TVD."""
    inp, out = case
    n, L, epochs = 6, 2, 25
    bn, latent, observed = _problem(n)
    post = bn.posterior_vector(latent, observed)
    op = SteinOperator(score_table(bn.conditional_joint_table(latent, observed)), n,
                       dtype=jnp.float64, dense=True)

    def probs(p):
        return ansatz_probs(p, n, L, "hardware_efficient", dtype=jnp.complex128
                            ).astype(jnp.float64)

    ref = run_ksd_scan(probs_fn=lambda p, r: probs(p), eval_probs_fn=probs,
                       params0=jnp.asarray(inp["theta6"]), op=op, num_epochs=epochs,
                       optimizer=make_optimizer("adam", 5e-3, epochs, True, (0.9, 0.999), 10.0),
                       entropy_weight=None, posterior_vec=jnp.asarray(post), early_stopping=False,
                       patience=0, key=jax.random.PRNGKey(0), reuse_loss_forward_for_eval=True)
    got = out[f"scan/D{shards}"]
    np.testing.assert_allclose(got["loss"], np.asarray(ref["loss_ksd"]), rtol=1e-9)
    np.testing.assert_allclose(got["tvd"], np.asarray(ref["tvd"]), rtol=1e-9, atol=1e-12)
    assert abs(got["best_tvd"] - float(ref["best_tvd"])) < 1e-9
    for theta in got["params_by_rank"][1:]:
        np.testing.assert_array_equal(theta, got["params_by_rank"][0])


@pytest.mark.parametrize("conditioning", (False, True))
def test_distributed_structured_ansatz_matches_single_device(case, conditioning):
    inp, out = case
    bn, latent, _ = _problem(6)
    edges = latent_edges(bn, latent)
    assert [tuple(e) for e in out["bn_edges"]] == [tuple(e) for e in edges]
    single = make_structured_probs_fn(6, 3, edges, dtype=jnp.complex128,
                                      conditioning=conditioning)
    p = jnp.asarray(inp["theta_bn"])
    if conditioning:
        want, got = single(p, jnp.asarray(inp["angles"])), out["bn_probs_cond"]
    else:
        want, got = single(p), out["bn_probs"]
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-12)


def test_distributed_engine_structured_with_conditioning_trains(case):
    """bn_structured with conditioning (float32, the engine's default) trains
    end to end; its epoch-0 loss is the JAX single-device loss of θ0."""
    _, out = case
    got = out["cond"]
    n, L = 5, 2
    bn, latent, observed = _problem(n)
    edges = latent_edges(bn, latent)
    assert [tuple(e) for e in got["edges"]] == [tuple(e) for e in edges]
    op = SteinOperator(score_table(bn.conditional_joint_table(latent, observed)), n,
                       dtype=jnp.float64, dense=True)
    probs = make_structured_probs_fn(n, L, edges, dtype=jnp.complex128, conditioning=True)
    angles = jnp.full((n,), np.pi)  # x = (1,), tiled over the 5 wires
    want = float(op.ksd_loss(probs(jnp.asarray(got["theta0"], dtype=jnp.float64), angles)
                             .astype(jnp.float64)))
    assert abs(got["loss"][0] - want) < 1e-5 * want
    assert got["loss"][-1] < got["loss"][0] * 0.8
    assert np.isfinite(got["best_tvd"])


def test_distributed_engine_chunked_resume_bit_identical(case):
    """Killed after one chunk (the fault injected into the engine module's
    ``run_ksd_scan`` on every rank) and resumed, the run equals the
    uninterrupted one bit for bit; rank 0's snapshot is there after the kill
    and gone at the end."""
    _, out = case
    r = out["resume"]
    assert r["killed"] and r["existed"] and r["removed"]
    full, resumed = r["full"], r["resumed"]
    np.testing.assert_array_equal(full[0], resumed[0])
    np.testing.assert_array_equal(full[1], resumed[1])
    assert full[2] == resumed[2]
    np.testing.assert_array_equal(full[3], resumed[3])


def test_distributed_engine_memory_sharded(case):
    """Each rank's score rows and probabilities hold 2^n/D states, and the
    engine trains on them."""
    _, out = case
    got = out["memory14"]
    assert got["S"] == (2**14 // 4, 14) and got["q"] == (2**14 // 4,)
    assert np.isfinite(got["loss"]).all()


def test_distributed_runner_lr_phases(case):
    """The runner chains LR-annealed restarts over the mesh and restores the
    across-phase best: the TVD of the restored θ is the best TVD."""
    _, out = case
    got = out["phases"]
    assert got["keys"] == ["history", "model", "num_qubits"]
    assert np.isfinite(got["best_tvd"])
    np.testing.assert_allclose(got["tvd"], got["best_tvd"], atol=1e-5)
