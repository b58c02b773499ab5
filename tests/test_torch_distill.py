"""The port's distillation engine against the JAX package:
``marginals_product``, ``fit_born_machine`` (tvd, kl and l2 losses, a
classical table and a quantum circuit) and ``fit_conditioned_born_machine``
(one conditioned circuit or conditional MLP against several targets).

Float64 on the CPU, from the same parameters on both sides (the JAX
classical machine's Flax table carried by ``interop.flat_from_flax``). The
JAX engine fits in float32 whatever its machine's dtype, so its module's
``jnp`` is patched to read float32 as float64 (the conditioned model's too,
which reads x as float32); the JAX package itself is unchanged. Histories
and best parameters to 1e-8 relative (20-30 epochs of Adam from the same
start). Chunked and unchunked runs are equal exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensornetworks_tpu.core import get_random_chain_network as j_chain
from tensornetworks_tpu.engines import distill as jdistill
from tensornetworks_tpu.models import ClassicalBornMachine as JCBM
from tensornetworks_tpu.models import QuantumBornMachine as JQBM
from tensornetworks_tpu.models import born_quantum as jborn
from tensornetworks_tpu.sim import latent_edges as j_latent_edges
from tensornetworks_tpu_torch.core import get_random_chain_network
from tensornetworks_tpu_torch.engines import (fit_born_machine, fit_conditioned_born_machine,
                                              marginals_product)
from tensornetworks_tpu_torch.interop import flat_from_flax
from tensornetworks_tpu_torch.models import ClassicalBornMachine, QuantumBornMachine
from tensornetworks_tpu_torch.sim import latent_edges

F64 = torch.float64


class F64Jnp:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def jax_f64(monkeypatch):
    monkeypatch.setattr(jdistill, "jnp", F64Jnp())
    monkeypatch.setattr(jborn, "jnp", F64Jnp())


def _target(n, seed):
    bn = get_random_chain_network(n + 1, seed=seed)
    latent = [f"V{i}" for i in range(n)]
    return bn.posterior_vector(latent, {f"V{n}": 1})


def _close(a, b, rel, what):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


def _machines(kind, n):
    """(JAX machine, port machine, JAX params, port params) from one start."""
    if kind == "classical":
        jm = JCBM(n, dtype=jnp.float64)
        tm = ClassicalBornMachine(n, dtype=F64, device="cpu")
        pj = jax.tree.map(lambda a: np.asarray(a, np.float64), jm.init(jax.random.PRNGKey(1)))
        pt = flat_from_flax(pj, tm.layout, "cpu", F64)
        return jm, tm, jax.tree.map(jnp.asarray, pj), pt
    L = 2
    jm = JQBM(n, ansatz_layers=L, dtype=jnp.complex128)
    tm = QuantumBornMachine(n, L, dtype=F64, device="cpu")
    theta = 0.3 * np.random.default_rng(n).normal(size=tm.num_params)
    return jm, tm, jnp.asarray(theta), torch.as_tensor(theta)


def _flat_j(params, tm):
    if isinstance(tm, ClassicalBornMachine):
        return flat_from_flax(jax.tree.map(np.asarray, params), tm.layout, "cpu", F64).numpy()
    return np.asarray(params)


@pytest.mark.parametrize("n", [3, 5])
def test_marginals_product_matches_jax(n):
    p = np.random.default_rng(n).random(2**n)
    p /= p.sum()
    np.testing.assert_allclose(marginals_product(p, n), jdistill.marginals_product(p, n),
                               rtol=1e-13, atol=0)


@pytest.mark.parametrize("loss", ["tvd", "kl", "l2"])
@pytest.mark.parametrize("kind", ["classical", "quantum"])
def test_fit_born_machine_matches_jax(kind, loss, jax_f64):
    n = 4
    target = _target(n, seed=2)
    jm, tm, pj, pt = _machines(kind, n)
    kw = dict(num_epochs=25, lr=0.05, loss=loss)
    best_j, hj = jdistill.fit_born_machine(jm, target, params0=pj, **kw)
    best_t, ht = fit_born_machine(tm, target, params0=pt, **kw)
    for key in ("loss", "tvd"):
        _close(ht[key], hj[key], 1e-8, key)
    assert ht["best_epoch"] == hj["best_epoch"]
    assert ht["best_tvd"] == pytest.approx(hj["best_tvd"], rel=1e-8)
    _close(best_t.numpy(), _flat_j(best_j, tm), 1e-8, "best params")
    # The best parameters reproduce the best TVD.
    q = tm.probs(best_t)
    assert float(0.5 * (q - torch.as_tensor(target)).abs().sum()) == pytest.approx(
        ht["best_tvd"], rel=1e-10)


def _conditioned(kind):
    """A conditioned machine (2 evidence bits), its targets and conditions."""
    n, d = 5, 2
    bn = j_chain(n + d, seed=4)
    latent = [f"V{i}" for i in range(n)]
    observed = [f"V{n}", f"V{n + 1}"]
    X = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]])
    targets = np.stack([bn.posterior_vector(latent, dict(zip(observed, x.astype(int))))
                        for x in X])
    if kind == "classical":
        cfg = dict(conditioning_dim=d, hidden_dims=[8, 6], dropout_rate=0.0)
        jm = JCBM(n, dtype=jnp.float64, **cfg)
        tm = ClassicalBornMachine(n, dtype=F64, device="cpu", **cfg)
        pj = jax.tree.map(lambda a: np.asarray(a, np.float64), jm.init(jax.random.PRNGKey(2)))
        return jm, tm, jax.tree.map(jnp.asarray, pj), flat_from_flax(pj, tm.layout, "cpu",
                                                                      F64), targets, X
    L = 3
    edges = j_latent_edges(bn, latent)
    assert edges == latent_edges(get_random_chain_network(n + d, seed=4), latent)
    kw = dict(conditioning_dim=d, edges=edges, cond_reupload=True, cond_learned_embedding=True,
              cond_embed_per_layer=True)
    jm = JQBM(n, ansatz_layers=L, ansatz_type="bn_structured", dtype=jnp.complex128, **kw)
    tm = QuantumBornMachine(n, L, "bn_structured", dtype=F64, device="cpu", **kw)
    params = tm.init(torch.Generator().manual_seed(0))
    params[:tm.num_circuit_params] = torch.as_tensor(
        0.3 * np.random.default_rng(5).normal(size=tm.num_circuit_params))
    return jm, tm, jnp.asarray(params.numpy()), params, targets, X


@pytest.mark.parametrize("kind", ["classical", "quantum"])
def test_fit_conditioned_born_machine_matches_jax(kind, jax_f64):
    jm, tm, pj, pt, targets, X = _conditioned(kind)
    assert tm.backend == "circuit2d" if kind == "quantum" else True
    kw = dict(num_epochs=20, lr=0.05)
    best_j, hj = jdistill.fit_conditioned_born_machine(jm, targets, X, params0=pj, **kw)
    best_t, ht = fit_conditioned_born_machine(tm, targets, X, params0=pt, **kw)
    for key in ("loss", "mean_tvd"):
        _close(ht[key], hj[key], 1e-8, key)
    assert ht["best_epoch"] == hj["best_epoch"]
    assert ht["best_mean_tvd"] == pytest.approx(hj["best_mean_tvd"], rel=1e-8)
    _close(best_t.numpy(), _flat_j(best_j, tm), 1e-8, "best params")


@pytest.mark.parametrize("conditioned", [False, True])
def test_chunked_equals_unchunked(conditioned):
    if conditioned:
        _, tm, _, pt, targets, X = _conditioned("quantum")
        runs = [fit_conditioned_born_machine(tm, targets, X, params0=pt, num_epochs=12,
                                             chunk_epochs=c) for c in (None, 5)]
        keys = ("loss", "mean_tvd")
    else:
        tm = QuantumBornMachine(4, 2, dtype=F64, device="cpu")
        target = _target(4, seed=3)
        runs = [fit_born_machine(tm, target, num_epochs=12, chunk_epochs=c, seed=1)
                for c in (None, 5)]
        keys = ("loss", "tvd")
    (b1, h1), (b2, h2) = runs
    assert torch.equal(b1, b2)
    for key in keys:
        np.testing.assert_array_equal(h1[key], h2[key])


def test_fit_rejects_unknown_loss_and_mismatched_batches():
    tm = ClassicalBornMachine(3, dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="Unknown distill loss"):
        fit_born_machine(tm, np.full(8, 1 / 8), num_epochs=2, loss="wasserstein")
    with pytest.raises(ValueError, match="leading observation axis"):
        fit_conditioned_born_machine(tm, np.full((2, 8), 1 / 8), np.zeros((3, 1)), num_epochs=2)
