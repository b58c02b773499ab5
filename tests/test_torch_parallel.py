"""The port's mesh and sharded training steps (``parallel/mesh.py``,
``parallel/sharded.py``) against the JAX package, after its
tests/test_parallel.py.

One spawn of 4 gloo ranks on the CPU runs every case in float64, on the
dp=1 mesh (4 state shards) and the dp=2 mesh of that world (2 state
shards, 2 replicas; for the discriminator, the batch over dp = 2 and 4).
The JAX references run in the pytest process: ``make_mesh`` on its
8-virtual-device CPU mesh for the shapes and errors, and its single-device
loss, gradient and optimizer step (``QuantumBornMachine``,
``SteinOperator``, ``stein_matvec``, ``BinaryClassifierMLP``), to which
its own tests pin its sharded steps, at 1e-10."""

import time

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tensornetworks_tpu.core import all_bitstrings, get_random_chain_network
from tensornetworks_tpu.engines.common import make_optimizer
from tensornetworks_tpu.models import BinaryClassifierMLP, QuantumBornMachine
from tensornetworks_tpu.ops import SteinOperator, score_table, stein_matvec
from tensornetworks_tpu.parallel import make_mesh
from tensornetworks_tpu_torch.interop import classifier_from_flax
from tensornetworks_tpu_torch.models import BinaryClassifierMLP as TClassifier
from tensornetworks_tpu_torch.parallel import spawn
from torch.multiprocessing import ProcessRaisedException

import torch_dist_ranks

SHARDS = (4, 2)


def _score6():
    bn = get_random_chain_network(7, seed=1)
    return score_table(bn.conditional_joint_table([f"V{i}" for i in range(6)], {"V6": 1}))


def _classifier():
    clf = BinaryClassifierMLP(input_dim=4, hidden_dims=[16, 8])
    variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                             clf.init_variables(jax.random.PRNGKey(0)))
    return clf, variables


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    qbm = QuantumBornMachine(6, ansatz_layers=2, dtype=jnp.complex128)
    theta = np.asarray(qbm.init(jax.random.PRNGKey(0)), dtype=np.float64)
    _, variables = _classifier()
    tclf = TClassifier(input_dim=4, hidden_dims=[16, 8], dtype=torch.float64, device="cpu")
    inp = {"S6": _score6(), "theta6": theta, "S_random": rng.normal(size=(2**6, 6)),
           "q6": rng.random(2**6),
           "clf_params": classifier_from_flax(variables, tclf, "cpu", torch.float64)[0].numpy(),
           "x": rng.random((16, 4)), "y": (np.arange(16) % 2).reshape(-1, 1).astype(np.float64)}
    out = spawn(torch_dist_ranks.parallel_cases, 4, "gloo", "cpu", inp, timeout_s=120)
    return inp, out


def test_mesh_construction(case):
    """(dp, state) shapes and the JAX function's two errors, word for word."""
    _, out = case
    assert out["shapes"] == [make_mesh(4, dp=2).devices.shape, make_mesh(4).devices.shape]
    with pytest.raises(ValueError, match="^requested 16 devices, only 8 available$"):
        make_mesh(16)
    with pytest.raises(ValueError, match="^n_devices=4 not divisible by dp=3$"):
        make_mesh(4, dp=3)
    assert out["errors"] == ["requested 8 devices, only 4 available",
                             "n_devices=4 not divisible by dp=3"]


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("dense", (False, True))
def test_sharded_ksd_step_matches_single_device(case, dense, shards):
    """One SGD step (clip, cosine schedule) through the sharded circuit and
    operator, the gcorr form and the row-sharded dense Gram."""
    inp, out = case
    qbm = QuantumBornMachine(6, ansatz_layers=2, dtype=jnp.complex128)
    op = SteinOperator(inp["S6"], 6, dtype=jnp.float64, dense=True)
    opt = make_optimizer("sgd", 5e-3, 10)
    params = jnp.asarray(inp["theta6"])

    def loss_fn(p):
        return op.ksd_loss(qbm.probs(p).astype(jnp.float64))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    upd, _ = opt.update(grads, opt.init(params), params)
    got_loss, got_params = out[f"ksd_step/dense={dense}/D{shards}"]
    assert abs(got_loss - float(loss)) < 1e-10
    np.testing.assert_allclose(got_params, np.asarray(optax.apply_updates(params, upd)),
                               atol=1e-10)


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_matvec_matches(case, shards):
    """The sharded n+1-column matvec on a random score table equals the JAX
    3n+1-column oracle on the whole vector."""
    inp, out = case
    S = jnp.asarray(inp["S_random"])
    B = jnp.asarray(all_bitstrings(6), dtype=S.dtype)
    want = np.asarray(stein_matvec(jnp.asarray(inp["q6"]), S, B, 6, 1.0, group=3))
    np.testing.assert_allclose(out[f"matvec/D{shards}"], want, rtol=1e-10)


@pytest.mark.parametrize("dp", (2, 4))
def test_sharded_classifier_step_matches_single_device(case, dp):
    """The discriminator step with the batch over dp ranks: the whole
    batch's BCE and one Adam step, as the JAX single-device step takes."""
    inp, out = case
    clf, variables = _classifier()
    opt = make_optimizer("adam", 1e-2, 10)
    x, y = jnp.asarray(inp["x"]), jnp.asarray(inp["y"])

    def loss_fn(params):
        logits = clf.apply({"params": params}, x, train=False)
        return jnp.mean(jnp.clip(logits, 0, None) - logits * y
                        + jnp.log1p(jnp.exp(-jnp.abs(logits))))

    params = variables["params"]
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    upd, _ = opt.update(grads, opt.init(params), params)
    new = {"params": optax.apply_updates(params, upd)}
    tclf = TClassifier(input_dim=4, hidden_dims=[16, 8], dtype=torch.float64, device="cpu")
    want = classifier_from_flax(new, tclf, "cpu", torch.float64)[0].numpy()
    got_loss, got_params = out[f"clf/dp{dp}"]
    assert np.isfinite(got_loss) and abs(got_loss - float(loss)) < 1e-10
    np.testing.assert_allclose(got_params, want, atol=1e-10)


def test_spawn_reraises_a_failing_rank():
    """A rank's exception ends the run at once, every rank killed, with that
    rank's traceback."""
    t0 = time.monotonic()
    with pytest.raises(ProcessRaisedException, match="rank 1 fails on purpose"):
        spawn(torch_dist_ranks.fail_on_rank, 2, "gloo", "cpu", 1, timeout_s=60)
    assert time.monotonic() - t0 < 60


def test_spawn_deadline_ends_a_hung_rank():
    """A rank that never reaches a collective fails the run at the deadline."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 6"):
        spawn(torch_dist_ranks.hang_on_rank, 2, "gloo", "cpu", 1, timeout_s=6)
    assert time.monotonic() - t0 < 30
