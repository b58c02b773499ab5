"""The port's amortized engines and runners against the JAX package:
``AmortizedKSD`` with a conditioned quantum Born machine (Sprinkler, n=3,
hardware_efficient; n=6-7 bn_structured re-uploading over 4 observations,
with the learned embedding and per-layer scales; the gcorr operator at
n=13) and with a conditional MLP, ``lr_phases``, chunking,
``posterior_for``, ``train_multi_seed`` (n=4, dense Gram; n=13, the gcorr
operator where JAX runs the 3n+1 matvec), ``run_amortized_experiment`` and
``run_scale_experiment(warm_start="marginals")``.

Float64 on the CPU from shared parameters: the JAX engines take
``dtype=jnp.float64`` and complex128 machines, and the modules that read
their conditions or fit targets as float32 get a ``jnp`` whose float32 is
float64 (patched in those modules only). The runners are held against the
JAX runners with both sides' engines and Born machines subclassed for
float64 and one θ, as tests/test_torch_scale.py does. Histories (loss,
mean TVD, gradient norm), best epochs, best TVDs and restored parameters
to 1e-8 relative. A circuit parameter whose gradient is zero whatever θ
(a rotation that only moves the phase, as an RZ at the end) gets round-off
gradients of 1e-16, which Adam turns into steps of up to lr·1e-8 (its
eps is 1e-8): those components are held to 1e-6 instead, and they do not
change the distribution."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tensornetworks_tpu.models as jmodels
from tensornetworks_tpu.core import get_random_chain_network as j_chain
from tensornetworks_tpu.core import get_sprinkler_network as j_sprinkler
from tensornetworks_tpu.engines import amortized as jamortized
from tensornetworks_tpu.engines import distill as jdistill
from tensornetworks_tpu.engines.ksd import QuantumKSDVariationalInference as JEngine
from tensornetworks_tpu.models import QuantumBornMachine as JQBM
from tensornetworks_tpu.models import born_quantum as jborn
from tensornetworks_tpu.runners import amortized as jrun_amortized
from tensornetworks_tpu.runners import scale as jscale
from tensornetworks_tpu.sim import latent_edges as j_latent_edges
from tensornetworks_tpu_torch.core import get_random_chain_network, get_sprinkler_network
from tensornetworks_tpu_torch.engines import (AmortizedKSD, QuantumKSDVariationalInference,
                                              train_multi_seed)
from tensornetworks_tpu_torch.interop import flat_from_flax
from tensornetworks_tpu_torch.models import ClassicalBornMachine, QuantumBornMachine
from tensornetworks_tpu_torch.ops.stein import SteinOperator, score_table
from tensornetworks_tpu_torch.runners import amortized as trun_amortized
from tensornetworks_tpu_torch.runners import scale as tscale
from tensornetworks_tpu_torch.parallel import spawn
from tensornetworks_tpu_torch.sim import latent_edges

import torch_dist_ranks

F64 = torch.float64
SPRINKLER = (["C", "S", "R"], ["W"])
HISTORY = ("loss", "mean_tvd", "grad_norm")


class F64Jnp:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def jax_f64(monkeypatch):
    for module in (jamortized, jborn, jdistill):
        monkeypatch.setattr(module, "jnp", F64Jnp())


def _close(a, b, rel, what):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


def _flat(params, bm):
    if isinstance(bm, ClassicalBornMachine):
        return flat_from_flax(jax.tree.map(np.asarray, params), bm.layout, "cpu", F64).numpy()
    return np.asarray(params)


def _round_off_gradient(loss_fn, params):
    """The parameters whose gradient of ``loss_fn`` at ``params`` is
    round-off."""
    p = torch.as_tensor(params).clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss_fn(p), p)
    return (g.abs() < 1e-12 * g.abs().max()).numpy()


def _null_directions(teng, observations, params):
    X = torch.tensor([teng._x(o) for o in observations], dtype=F64)
    ops = teng.operators(observations)

    def loss(p):
        q = torch.stack([teng.born_machine.probs(p, x) for x in X])
        return torch.stack([op.ksd_loss(qx) for op, qx in zip(ops, q)]).mean()

    return _round_off_gradient(loss, params)


def _assert_runs_match(jeng, hj, teng, ht, rel=1e-8, null=None):
    for key in HISTORY:
        _close(ht[key], hj[key], rel, key)
    assert teng.best_epoch_ == jeng.best_epoch_
    assert teng.best_mean_tvd_ == pytest.approx(jeng.best_mean_tvd_, rel=rel)
    got, want = teng.params.numpy(), _flat(jeng.params, teng.born_machine)
    live = np.ones(got.shape, bool) if null is None else ~null
    _close(got[live], want[live], rel, "restored params")
    np.testing.assert_allclose(got[~live], want[~live], rtol=0, atol=1e-6)


def _chain_problem(n, d, seed=0):
    """A random chain network of n + d variables, V0..V{n-1} latent, the
    last d observed, and all 2^d observations."""
    from itertools import product

    latent = [f"V{i}" for i in range(n)]
    observed = [f"V{n + i}" for i in range(d)]
    observations = [dict(zip(observed, bits)) for bits in product((0, 1), repeat=d)]
    return (j_chain(n + d, seed=seed), get_random_chain_network(n + d, seed=seed), latent,
            observed, observations)


QUANTUM_CASES = {
    # name: (n, d, L, ansatz, machine keywords, epochs, lr, length scale)
    "sprinkler-he": (3, 1, 3, "hardware_efficient", {}, 30, 0.02, 1.0),
    "bn7-reupload": (7, 2, 3, "bn_structured", dict(cond_reupload=True), 20, 0.05, "auto"),
    "bn6-learned-per-layer": (6, 2, 4, "bn_structured",
                              dict(cond_reupload=True, cond_learned_embedding=True,
                                   cond_embed_per_layer=True), 20, 0.05, "auto"),
    "he13-gcorr": (13, 1, 1, "hardware_efficient", {}, 3, 0.05, "auto"),
}


def _quantum_engines(case):
    n, d, L, ansatz, kw, epochs, lr, ls = QUANTUM_CASES[case]
    if case.startswith("sprinkler"):
        jbn, tbn = j_sprinkler(), get_sprinkler_network()
        latent, observed = SPRINKLER
        observations = [{"W": 0}, {"W": 1}]
    else:
        jbn, tbn, latent, observed, observations = _chain_problem(n, d)
    edges = j_latent_edges(jbn, latent) if ansatz == "bn_structured" else None
    if edges is not None:
        assert edges == latent_edges(tbn, latent)
    jm = JQBM(n, ansatz_layers=L, conditioning_dim=d, ansatz_type=ansatz, edges=edges,
              dtype=jnp.complex128, **kw)
    tm = QuantumBornMachine(n, L, ansatz, dtype=F64, device="cpu", edges=edges,
                            conditioning_dim=d, **kw)
    params = tm.init(torch.Generator().manual_seed(0))
    params[:tm.num_circuit_params] = torch.as_tensor(
        0.2 * np.random.default_rng(n).normal(size=tm.num_circuit_params))
    jeng = jamortized.AmortizedKSD(jbn, latent, observed, born_machine=jm, dtype=jnp.float64,
                                   base_kernel_length_scale=ls)
    teng = AmortizedKSD(tbn, latent, observed, born_machine=tm, base_kernel_length_scale=ls)
    jeng.params, teng.params = jnp.asarray(params.numpy()), params.clone()
    return jeng, teng, observations, dict(num_epochs=epochs, lr=lr, verbose=False)


@pytest.mark.parametrize("case", list(QUANTUM_CASES))
def test_quantum_amortized_matches_jax(case, jax_f64):
    """Eval on the loss forward (lagging one epoch, shifted after the final
    evaluation, epoch 0 no best candidate), best-mean-TVD restore."""
    jeng, teng, observations, kw = _quantum_engines(case)
    ops = teng.operators(observations)
    assert all(op.dense == (teng.num_latent_vars <= 12) for op in ops)
    assert teng.born_machine.backend == "circuit2d"
    null = _null_directions(teng, observations, teng.params)
    hj = jeng.train(observations, **kw)
    ht = teng.train(observations, **kw)
    _assert_runs_match(jeng, hj, teng, ht, null=null)
    assert ht["num_skipped_updates"] == 0 and teng.best_epoch_ >= 0
    for obs in observations:
        _close(teng.posterior_for(obs).numpy(), jeng.posterior_for(obs), 1e-8, str(obs))


def _classical_engines(n=4, d=1, hidden=(8, 6)):
    jbn, tbn, latent, observed, observations = _chain_problem(n, d, seed=3)
    cfg = {"use_logits": True, "dropout_rate": 0.0, "hidden_dims": list(hidden)}
    jeng = jamortized.AmortizedKSD(jbn, latent, observed, born_machine_config=cfg,
                                   dtype=jnp.float64, base_kernel_length_scale="auto")
    teng = AmortizedKSD(tbn, latent, observed, born_machine_config=cfg, dtype=F64,
                        device="cpu", base_kernel_length_scale="auto")
    pj = jax.tree.map(lambda a: np.asarray(a, np.float64), jeng.params)
    jeng.params = jax.tree.map(jnp.asarray, pj)
    teng.params = flat_from_flax(pj, teng.born_machine.layout, "cpu", F64)
    return jeng, teng, observations


def test_classical_amortized_matches_jax(jax_f64):
    """The conditional MLP (dropout 0): a separate eval forward after each
    update, the best epoch counted from 0."""
    jeng, teng, observations = _classical_engines()
    kw = dict(num_epochs=25, lr=1e-2, verbose=False)
    hj, ht = jeng.train(observations, **kw), teng.train(observations, **kw)
    _assert_runs_match(jeng, hj, teng, ht)
    for obs in observations:
        _close(teng.posterior_for(obs).numpy(), jeng.posterior_for(obs), 1e-8, str(obs))


def test_lr_phases_match_jax(jax_f64):
    """Two phases, the second at its own length scale (new operators),
    each restarting from the best so far; the across-phase best restored."""
    jeng, teng, observations, _ = _quantum_engines("bn7-reupload")
    phases = [(8, 0.05), (6, 0.01, 0.3)]
    null = _null_directions(teng, observations, teng.params)
    hj = jeng.train(observations, lr_phases=phases, verbose=False)
    ht = teng.train(observations, lr_phases=phases, verbose=False)
    assert teng.length_scale == jeng.length_scale == 0.3
    assert len(teng._ops) == 2  # one operator set per length scale
    for key in HISTORY:
        _close(ht[key], hj[key], 1e-8, key)
    assert teng.best_mean_tvd_ == pytest.approx(jeng.best_mean_tvd_, rel=1e-8)
    got, want = teng.params.numpy(), np.asarray(jeng.params)
    _close(got[~null], want[~null], 1e-8, "restored params")
    np.testing.assert_allclose(got[null], want[null], rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["quantum", "classical"])
def test_chunked_equals_unchunked(kind):
    runs = []
    for chunk in (None, 4):
        if kind == "quantum":
            _, teng, observations, kw = _quantum_engines("sprinkler-he")
            kw = dict(kw, num_epochs=11)
        else:
            _, teng, observations = _classical_engines()
            kw = dict(num_epochs=11, lr=1e-2, verbose=False)
        runs.append((teng.train(observations, chunk_epochs=chunk, **kw), teng))
    (h1, e1), (h2, e2) = runs
    for key in HISTORY:
        np.testing.assert_array_equal(h1[key], h2[key])
    assert torch.equal(e1.params, e2.params) and e1.best_epoch_ == e2.best_epoch_
    assert "epochs_per_sec_steady" in h2 and "epochs_per_sec_steady" not in h1


def test_posterior_for_is_the_restored_model():
    _, teng, observations, kw = _quantum_engines("sprinkler-he")
    teng.train(observations, **kw)
    bm = teng.born_machine
    tvds = []
    for obs in observations:
        q = teng.posterior_for(obs)
        torch.testing.assert_close(q, bm.probs(teng.params, [float(obs["W"])]))
        post = torch.as_tensor(teng.bn.posterior_vector(teng.latent_vars_names, obs))
        tvds.append(float(0.5 * (q - post).abs().sum()))
    assert np.mean(tvds) == pytest.approx(teng.best_mean_tvd_, rel=1e-10)


def test_mesh_on_two_ranks_matches_single_device():
    """``mesh=`` on a 2-rank gloo mesh (one observation, one seed a rank)
    runs and matches the single-device run: the amortized engine's history,
    best and restored θ to 1e-9 (θ's round-off directions to 1e-6, as in
    the JAX comparisons above), the seeds' results to 1e-12."""
    _, teng, observations, kw = _quantum_engines("sprinkler-he")
    _, _, L, _, _, epochs, lr, ls = QUANTUM_CASES["sprinkler-he"]
    live = ~_null_directions(teng, observations, teng.params)
    inp = {"layers": L, "length_scale": ls, "params": teng.params.numpy(),
           "observations": observations, "epochs": epochs, "lr": lr}
    got = spawn(torch_dist_ranks.amortized_two_ranks, 2, "gloo", "cpu", inp, timeout_s=120)
    h = teng.train(observations, **kw)
    for key in ("loss", "mean_tvd"):
        np.testing.assert_allclose(got[key], h[key], rtol=1e-9, atol=1e-12)
    assert got["best"] == pytest.approx(teng.best_mean_tvd_, rel=1e-9)
    _close(got["params"][live], teng.params.numpy()[live], 1e-9, "restored params")
    np.testing.assert_allclose(got["params"][~live], teng.params.numpy()[~live], rtol=0,
                               atol=1e-6)
    want = train_multi_seed(get_sprinkler_network(), *SPRINKLER[:1], {"W": 1}, num_seeds=2,
                            ansatz_layers=2, num_epochs=20, dtype=F64, device="cpu")
    np.testing.assert_allclose(got["seeds"][0], want[0].numpy(), rtol=1e-12, atol=1e-14)
    for a, b in zip(got["seeds"][1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)


class JQ128(JQBM):
    def __init__(self, *a, **kw):
        super().__init__(*a, dtype=jnp.complex128, **kw)


@pytest.mark.parametrize("n", [4, 13])
def test_train_multi_seed_matches_jax(n, monkeypatch, jax_f64):
    """K replicas from ``params0``: per-seed losses and post-update TVDs and
    the final parameters. From n=13 JAX runs the 3n+1 matvec and the port
    the gcorr operator (the same quadratic form). The JAX function builds a
    complex64 machine: it gets a complex128 one."""
    monkeypatch.setattr(jamortized, "QuantumBornMachine", JQ128)
    K, L, epochs = 3, 1 if n > 12 else 2, 3 if n > 12 else 12
    jbn, tbn = j_chain(n + 1, seed=0), get_random_chain_network(n + 1, seed=0)
    latent, obs = [f"V{i}" for i in range(n)], {f"V{n}": 1}
    params0 = 0.3 * np.random.default_rng(n).normal(size=(K, 3 * L * n))
    kw = dict(num_seeds=K, ansatz_layers=L, num_epochs=epochs, lr=0.05, params0=params0)
    jp, jt, jl = jamortized.train_multi_seed(jbn, latent, obs, **kw)
    tp, tt, tl = train_multi_seed(tbn, latent, obs, dtype=F64, device="cpu", **kw)
    assert tt.shape == tl.shape == (epochs, K)
    _close(tl, jl, 1e-8, "losses")
    _close(tt, jt, 1e-8, "tvds")
    qbm = QuantumBornMachine(n, L, dtype=F64, device="cpu")
    op = SteinOperator(score_table(tbn.conditional_joint_table(latent, obs)), n, device="cpu",
                       dtype=F64)
    for k in range(K):
        null = _round_off_gradient(lambda p: op.ksd_loss(qbm.probs(p)), params0[k])
        _close(tp[k].numpy()[~null], np.asarray(jp[k])[~null], 1e-8, f"params of seed {k}")
        np.testing.assert_allclose(tp[k].numpy()[null], np.asarray(jp[k])[null], atol=1e-6)
    # Replica k is the single run from params0[k].
    _, t1, l1 = train_multi_seed(tbn, latent, obs, dtype=F64, device="cpu",
                                 **dict(kw, num_seeds=1, params0=params0[1:2]))
    np.testing.assert_array_equal(l1[:, 0], tl[:, 1])
    np.testing.assert_array_equal(t1[:, 0], tt[:, 1])


@pytest.mark.parametrize("quantum", [True, False], ids=["quantum", "classical"])
def test_run_amortized_experiment_matches_jax(quantum, monkeypatch, jax_f64):
    n, L = 4, 2
    theta = 0.2 * np.random.default_rng(4).normal(size=3 * L * n)
    flax = {}

    class JQ(JQ128):
        def init(self, key):
            return jnp.asarray(theta)

    class TQ(QuantumBornMachine):
        def __init__(self, *a, **kw):
            super().__init__(*a, dtype=F64, **dict(kw, device="cpu"))

        def init(self, generator):
            return torch.as_tensor(theta)

    class J(jamortized.AmortizedKSD):
        def __init__(self, *a, **kw):
            super().__init__(*a, dtype=jnp.float64, **kw)
            if not quantum:
                flax["params"] = jax.tree.map(lambda a: np.asarray(a, np.float64), self.params)
                self.params = jax.tree.map(jnp.asarray, flax["params"])

    class T(AmortizedKSD):
        def __init__(self, *a, **kw):
            super().__init__(*a, dtype=F64, **dict(kw, device="cpu"))
            if not quantum:
                self.params = flat_from_flax(flax["params"], self.born_machine.layout, "cpu",
                                             F64)

    monkeypatch.setattr(jmodels, "QuantumBornMachine", JQ)
    monkeypatch.setattr(trun_amortized, "QuantumBornMachine", TQ)
    monkeypatch.setattr(jrun_amortized, "AmortizedKSD", J)
    monkeypatch.setattr(trun_amortized, "AmortizedKSD", T)
    kw = dict(num_qubits=n, num_epochs=8, lr=0.02, layers=L, quantum=quantum, seed=1,
              verbose=False, chunk_epochs=3)
    jout = jrun_amortized.run_amortized_experiment(**kw)
    tout = trun_amortized.run_amortized_experiment(device="cpu", **kw)
    for key in HISTORY:
        _close(tout["history"][key], jout["history"][key], 1e-8, key)
    assert sorted(tout["per_obs_tvd"]) == [0, 1]
    for k, v in jout["per_obs_tvd"].items():
        assert tout["per_obs_tvd"][k] == pytest.approx(v, rel=1e-8)


def test_run_scale_experiment_warm_start_matches_jax(monkeypatch, jax_f64):
    """``warm_start="marginals"``: the distillation toward the posterior's
    marginals product, then KSD from the fitted θ, against the JAX runner
    from one θ."""
    n, L = 5, 2
    theta = 0.2 * np.random.default_rng(5).normal(size=3 * L * n)

    class J(JEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, dtype=jnp.float64, **kw)
            self.born_machine = JQBM(n, ansatz_layers=L, dtype=jnp.complex128)
            self.born_machine.init = lambda key: jnp.asarray(theta)
            self.params = jnp.asarray(theta)

    class T(QuantumKSDVariationalInference):
        def __init__(self, *a, **kw):
            super().__init__(*a, dtype=F64, **kw)
            self.born_machine.init = lambda generator: torch.as_tensor(theta)
            self.params = torch.as_tensor(theta)

    monkeypatch.setattr(jscale, "QuantumKSDVariationalInference", J)
    monkeypatch.setattr(tscale, "QuantumKSDVariationalInference", T)
    kw = dict(num_qubits=n, layers=L, num_epochs=6, lr=0.05, seed=0, verbose=False,
              warm_start="marginals", warm_start_epochs=15, chunk_epochs=4)
    jout = jscale.run_scale_experiment(**kw)
    tout = tscale.run_scale_experiment(device="cpu", **kw)
    for key in ("loss_ksd", "tvd", "grad_norm"):
        _close(tout["history"][key], jout["history"][key], 1e-8, key)
    assert tout["model"].best_tvd_ == pytest.approx(jout["model"].best_tvd_, rel=1e-8)
    warm = tout["warm_start"]
    assert len(warm["tvd"]) == 15 and warm["best_tvd"] < warm["tvd"][0]


@pytest.mark.parametrize("kwargs,match", [
    (dict(warm_start="uniform"), "unknown warm_start"),
    (dict(warm_start="marginals", objective="adversarial"), "ksd objective")])
def test_run_scale_experiment_warm_start_errors(kwargs, match):
    with pytest.raises(ValueError, match=match):
        tscale.run_scale_experiment(num_qubits=3, layers=1, num_epochs=1, device="cpu", **kwargs)
