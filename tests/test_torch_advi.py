"""The port's adversarial VI slice against the JAX package: the
discriminator (forward, gradient, BatchNorm running statistics), the
``log p(x|z)`` table with its ±inf edges, the floor (without it a -inf
entry skips every Born update in both engines), the BCE gradient at a zero
logit (where the JAX form differs), the engine over a
few epochs from the same parameters and the same sample indices (a
conditional and a table classical Born machine, with and without BatchNorm,
and a quantum Born machine), the scale runner's adversarial branch at n=4
and the Sprinkler runner.

The same indices: the port's engine takes a ``sampler``; on the JAX side
the test patches ``jax.random.categorical`` to return, per call site, the
same fixed indices (the JAX package is unchanged). Per epoch both call,
in order, the Born and prior batches of each discriminator step, then the
REINFORCE batch. Float64 on the CPU. Tolerances: 1e-12 on single
forwards and gradients; 1e-7 relative on engine histories and best TVDs,
because Adam's normalisation turns round-off in near-zero gradient
components (of the discriminator, then through the reward, of the Born
machine) into differences of ~1e-9 within a few epochs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensornetworks_tpu.core import get_sprinkler_network as j_sprinkler
from tensornetworks_tpu.core.bayes_net import BayesianNetwork as JBN
from tensornetworks_tpu.engines.advi import AdversarialVariationalInference as JADV
from tensornetworks_tpu.models import QuantumBornMachine as JQBM
from tensornetworks_tpu.models.classifier import BinaryClassifierMLP as JCLF
from tensornetworks_tpu.runners import scale as jscale
from tensornetworks_tpu.runners.configs import AdversarialConfig as JAdvConfig
from tensornetworks_tpu.runners.sprinkler_adversarial import run_sprinkler_experiment as j_run
from tensornetworks_tpu_torch.core import BayesianNetwork, get_sprinkler_network
from tensornetworks_tpu_torch.engines import AdversarialVariationalInference
from tensornetworks_tpu_torch.engines.advi import multinomial_sampler
from tensornetworks_tpu_torch.interop import classifier_from_flax, flat_from_flax, params_from_jax
from tensornetworks_tpu_torch.models import BinaryClassifierMLP, QuantumBornMachine
from tensornetworks_tpu_torch.runners import AdversarialConfig, run_sprinkler_experiment
from tensornetworks_tpu_torch.runners import scale as tscale

F64 = torch.float64
SPRINKLER = (["C", "S", "R"], {"W": 1})
HISTORY_KEYS = ("loss_classifier", "loss_born_machine", "tvd", "grad_norm_born",
                "grad_norm_classifier")


def _np64(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float64), tree)


def _off_zero(variables, seed=0):
    """The discriminator's variables in float64 with noise on every leaf. At
    init its biases are 0, so the all-zeros input of an unconditioned Born
    machine gets a logit of exactly 0, where the two BCE forms differ: the
    port's gradient is σ(0) - y, JAX's subgradients give -y."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)
                                              + 0.05 * rng.normal(size=np.shape(a))), variables)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_classifier_matches_flax(batch_norm):
    jc = JCLF(input_dim=5, use_batch_norm=batch_norm)
    tc = BinaryClassifierMLP(5, use_batch_norm=batch_norm, dtype=F64, device="cpu")
    assert tc.hidden_dims == (32, 16)
    rng = np.random.default_rng(0)
    variables = jax.tree.map(lambda a: np.asarray(a, np.float64) + 0.05 * rng.normal(size=a.shape),
                             jc.init_variables(jax.random.PRNGKey(0)))
    if batch_norm:
        variables["batch_stats"] = jax.tree.map(np.abs, variables["batch_stats"])
    params, stats = classifier_from_flax(variables, tc, "cpu", F64)
    jv = jax.tree.map(jnp.asarray, variables)
    x = rng.normal(size=(7, 5))
    for train in ((False, True) if batch_norm else (False,)):
        def jloss(p):
            out = jc.apply({**jv, "params": p}, jnp.asarray(x), train=train,
                           mutable=["batch_stats"] if train else False)
            logits = out[0] if train else out
            return jnp.sum(jnp.sin(logits)), out
        (lj, out_j), gj = jax.value_and_grad(jloss, has_aux=True)(jv["params"])
        p = params.clone().requires_grad_(True)
        logits, new_stats = tc.logits(p, torch.as_tensor(x), stats, train=train)
        torch.sin(logits).sum().backward()
        assert float(torch.sin(logits).sum().detach()) == pytest.approx(float(lj), abs=1e-12)
        np.testing.assert_allclose(p.grad.numpy(),
                                   flat_from_flax(_np64(gj), tc.layout, "cpu", F64).numpy(),
                                   rtol=0, atol=1e-12)
        if train:  # Flax's running statistics after one train-mode step
            want = flat_from_flax(_np64(out_j[1]["batch_stats"]), tc.stats_layout, "cpu", F64)
            np.testing.assert_allclose(new_stats.numpy(), want.numpy(), rtol=0, atol=1e-14)
        else:
            assert new_stats is stats
    np.testing.assert_allclose(tc.get_probs(params, torch.as_tensor(x), stats).numpy(),
                               np.asarray(jc.get_probs(jv, jnp.asarray(x))), atol=1e-12)


def test_classifier_init_is_lecun_normal():
    tc = BinaryClassifierMLP(200, hidden_dims=[400, 300], use_batch_norm=True, dtype=F64,
                             device="cpu")
    params, stats = tc.init(torch.Generator().manual_seed(0))
    v = dict(zip([f"{m}.{leaf}" for m, leaf, _ in tc.layout],
                 torch.split(params, [int(np.prod(s)) for _, _, s in tc.layout])))
    w = v["Dense_0.weight"]
    assert abs(float(w.std()) - np.sqrt(1 / 200)) < 0.02 * np.sqrt(1 / 200)
    assert float(w.abs().max()) <= 2.0 * np.sqrt(1 / 200) / 0.87962566103423978
    assert not v["Dense_1.bias"].any() and torch.equal(v["BatchNorm_0.scale"],
                                                       torch.ones(400, dtype=F64))
    assert torch.equal(stats, torch.cat([torch.zeros(400), torch.ones(400),
                                         torch.zeros(300), torch.ones(300)]).double())


def _networks():
    """A over {0,1} with p(A=1)=0: every latent state with A=1 has prior 0."""
    nets = []
    for cls in (BayesianNetwork, JBN):
        bn = cls()
        bn.add_node("A", cpt={(): {0: 1.0, 1: 0.0}})
        bn.add_node("B", cpt={(0,): {0: 0.3, 1: 0.7}, (1,): {0: 0.5, 1: 0.5}},
                    parent_names=["A"])
        bn.add_node("X", cpt={(0, 0): {0: 0.9, 1: 0.1}, (0, 1): {0: 0.2, 1: 0.8},
                              (1, 0): {0: 0.5, 1: 0.5}, (1, 1): {0: 0.5, 1: 0.5}},
                    parent_names=["A", "B"])
        nets.append(bn)
    return nets


def test_log_p_table_matches_jax_with_inf_edges_and_floor():
    tbn, jbn = _networks()
    teng = AdversarialVariationalInference(tbn, ["A", "B"], ["X"], device="cpu")
    jeng = JADV(jbn, ["A", "B"], ["X"], dtype=jnp.float64)
    np.testing.assert_array_equal(teng.prior_z_probs, np.asarray(jeng.prior_z_probs))
    assert teng.prior_z_dist_dict == jeng.prior_z_dist_dict
    table = teng._log_p_x_given_z_table({"X": 1})
    np.testing.assert_array_equal(table, jeng._log_p_x_given_z_table({"X": 1}))
    assert np.isfinite(table[:2]).all() and np.isneginf(table[2:]).all()
    # The +inf edge: a prior below 1e-9 where the joint is not (index 0);
    # the joint is 0 at indices 2 and 3, and the prior too at 3.
    for eng in (teng, jeng):
        eng.prior_z_probs = np.array([1e-12, 0.7, 0.3, 0.0])
    table = teng._log_p_x_given_z_table({"X": 1})
    np.testing.assert_array_equal(table, jeng._log_p_x_given_z_table({"X": 1}))
    assert np.isposinf(table[0]) and np.isfinite(table[1:3]).all() and np.isneginf(table[3])
    assert table[2] == pytest.approx(np.log(1e-9))


@pytest.mark.parametrize("floor", [None, 60.0])
def test_infinite_log_p_skips_updates_unless_floored(monkeypatch, floor):
    """REINFORCE samples on a state whose prior is 0 (log p(x|z) = -inf):
    without the floor every Born loss is non-finite and both engines skip
    every Born update; with it both train, and agree."""
    tbn, jbn = _networks()
    cfg = {"conditioning_dim": 1, "dropout_rate": 0.0, "hidden_dims": [8, 4]}
    jeng = JADV(jbn, ["A", "B"], ["X"], cfg, {"hidden_dims": [8, 4]}, dtype=jnp.float64)
    jeng.born_params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jeng.born_params)
    jeng.classifier_vars = _off_zero(jeng.classifier_vars)
    teng = AdversarialVariationalInference(tbn, ["A", "B"], ["X"], cfg, {"hidden_dims": [8, 4]},
                                           dtype=F64, device="cpu")
    teng.born_params = flat_from_flax(_np64(jeng.born_params), teng.born_machine.layout,
                                      "cpu", F64)
    teng.classifier_params, _ = classifier_from_flax(_np64(jeng.classifier_vars),
                                                     teng.classifier, "cpu", F64)
    born0 = teng.born_params.clone()
    post = tbn.posterior_vector(["A", "B"], {"X": 1})
    hj, ht = _train_both(monkeypatch, jeng, teng, {"X": 1}, 1, 8, 4, num_epochs=4,
                         lr_born_machine=0.05, lr_classifier=0.1,
                         true_posterior_for_tvd=post, log_p_floor=floor)
    if floor is None:
        assert not np.isfinite(ht["loss_born_machine"]).any()
        assert not np.isfinite(hj["loss_born_machine"]).any()
        assert torch.equal(teng.born_params, born0)
    else:
        _assert_match(ht, hj, teng, jeng)
        assert np.isfinite(ht["loss_born_machine"]).all()
        assert not torch.equal(teng.born_params, born0)


class _Sites:
    """Fixed indices per call site, the same sequence every epoch."""

    def __init__(self, num_sites, batch, size, seed=0):
        rng = np.random.default_rng(seed)
        self.sites = [rng.integers(0, size, size=batch) for _ in range(num_sites)]
        self.calls = 0

    def _next(self):
        out = self.sites[self.calls % len(self.sites)]
        self.calls += 1
        return out

    def jax_categorical(self, key, logits, axis=-1, shape=None):
        return jnp.asarray(self._next(), dtype=jnp.int32)

    def torch_sampler(self, probs, num_samples, generator):
        assert probs.shape[-1] == 2 ** int(np.log2(probs.shape[-1])) and num_samples > 0
        return torch.as_tensor(self._next())


def _train_both(monkeypatch, jeng, teng, obs, k_d, batch, size, **kw):
    js, ts = _Sites(2 * k_d + 1, batch, size), _Sites(2 * k_d + 1, batch, size)
    kw = dict(batch_size=batch, k_classifier_steps=k_d, verbose=False, **kw)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "categorical", js.jax_categorical)
        hj = jeng.train(obs, **kw)
    ht = teng.train(obs, sampler=ts.torch_sampler, **kw)
    assert js.calls % (2 * k_d + 1) == 0  # each trace meets each site once
    assert ts.calls == kw["num_epochs"] * (2 * k_d + 1)
    return hj, ht


def _assert_match(ht, hj, teng, jeng):
    for key in HISTORY_KEYS:
        np.testing.assert_allclose(ht[key], hj[key], rtol=1e-7, atol=1e-12, err_msg=key)
    assert teng.best_epoch_ == jeng.best_epoch_
    assert teng.best_tvd_ == pytest.approx(jeng.best_tvd_, rel=1e-7)


CLASSICAL_CASES = {
    "conditional": ({"conditioning_dim": 1, "dropout_rate": 0.0}, {}),
    "conditional-batchnorm": ({"conditioning_dim": 1, "dropout_rate": 0.0,
                               "hidden_dims": [16, 8]},
                              {"use_batch_norm": True, "hidden_dims": [16, 8]}),
    "table-batchnorm": ({"conditioning_dim": 0}, {"use_batch_norm": True}),
}


@pytest.mark.parametrize("case", list(CLASSICAL_CASES))
def test_engine_matches_jax_on_the_same_samples(monkeypatch, case):
    bm_cfg, clf_cfg = CLASSICAL_CASES[case]
    latent, obs = SPRINKLER
    jeng = JADV(j_sprinkler(), latent, list(obs), bm_cfg, clf_cfg, dtype=jnp.float64)
    jeng.born_params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jeng.born_params)
    jeng.classifier_vars = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                        jeng.classifier_vars)
    teng = AdversarialVariationalInference(get_sprinkler_network(), latent, list(obs), bm_cfg,
                                           clf_cfg, dtype=F64, device="cpu")
    assert teng.classifier_input_dim == jeng.classifier_input_dim
    teng.born_params = flat_from_flax(_np64(jeng.born_params), teng.born_machine.layout,
                                      "cpu", F64)
    teng.classifier_params, teng.classifier_stats = classifier_from_flax(
        _np64(jeng.classifier_vars), teng.classifier, "cpu", F64)
    post, _ = get_sprinkler_network().get_true_posterior(latent, obs)
    hj, ht = _train_both(monkeypatch, jeng, teng, obs, 2, 24, 8, num_epochs=6,
                         lr_born_machine=0.05, lr_classifier=0.1, baseline_decay=0.9,
                         true_posterior_for_tvd=post)
    _assert_match(ht, hj, teng, jeng)
    # Both restore the best snapshot of both networks.
    assert teng.get_prob_dict() == pytest.approx(jeng.get_prob_dict(), abs=1e-7)
    np.testing.assert_allclose(
        teng.classifier_params.numpy(),
        flat_from_flax(_np64(jeng.classifier_vars["params"]), teng.classifier.layout,
                       "cpu", F64).numpy(), atol=1e-7)


@pytest.mark.parametrize("ansatz,n,layers", [("hardware_efficient", 4, 2),
                                             ("bn_structured", 5, 3)])
def test_quantum_engine_matches_jax_on_the_same_samples(monkeypatch, ansatz, n, layers):
    """One circuit forward per epoch in the port (it serves the epoch's
    samples, its REINFORCE gradient and the previous epoch's evaluation)
    against the JAX engine's k_D + 2, with the floor on log p(x|z)."""
    bn, latent, obs = tscale.make_scale_problem(n, seed=1)
    jbn, _, _ = jscale.make_scale_problem(n, seed=1)
    edges = None
    if ansatz == "bn_structured":
        from tensornetworks_tpu_torch.sim.structured import latent_edges
        edges = latent_edges(bn, latent)
    jqbm = JQBM(n, ansatz_layers=layers, ansatz_type=ansatz, edges=edges, dtype=jnp.complex128)
    tqbm = QuantumBornMachine(n, layers, ansatz, dtype=F64, device="cpu", edges=edges)
    assert tqbm.backend == "circuit2d"
    jeng = JADV(jbn, latent, list(obs), born_machine=jqbm, dtype=jnp.float64, seed=2)
    jeng.classifier_vars = _off_zero(jeng.classifier_vars)
    teng = AdversarialVariationalInference(bn, latent, list(obs), born_machine=tqbm, dtype=F64,
                                           device="cpu")
    theta = 0.3 * np.random.default_rng(n).normal(size=tqbm.num_params)
    jeng.born_params = jnp.asarray(theta)
    teng.born_params = params_from_jax(theta, device="cpu", dtype=F64)
    teng.classifier_params, _ = classifier_from_flax(_np64(jeng.classifier_vars),
                                                     teng.classifier, "cpu", F64)
    post = bn.posterior_vector(latent, obs)
    hj, ht = _train_both(monkeypatch, jeng, teng, obs, 3, 32, 2**n, num_epochs=7,
                         lr_born_machine=0.05, lr_classifier=0.5, baseline_decay=0.95,
                         adam_betas=(0.5, 0.999), gradient_clip_norm=5.0,
                         true_posterior_for_tvd=post, log_p_floor=60.0, chunk_epochs=3)
    _assert_match(ht, hj, teng, jeng)
    assert ht["tvd"][-1] != ht["tvd"][0] and "epochs_per_sec_steady" in ht
    np.testing.assert_allclose(teng.born_params.numpy(), np.asarray(jeng.born_params),
                               atol=1e-7)


def test_scale_runner_adversarial_matches_the_jax_runner(monkeypatch):
    """``run_scale_experiment(objective="adversarial")`` at n=4 with two
    phases against the JAX runner: both engines in float64, started from
    the same θ and discriminator and fed the same indices. The runners pick
    the rest: discriminator widths, batch, k_D, lr_D, clip, baseline decay,
    betas, per-phase seeds, the floor, the across-phase best."""
    n, phases, k_d = 4, [(5, 0.05), (4, 0.01)], 2
    theta = 0.3 * np.random.default_rng(0).normal(size=3 * 2 * n)
    jsites, tsites = _Sites(2 * k_d + 1, 16, 2**n), _Sites(2 * k_d + 1, 16, 2**n)
    made = {}

    class J(JADV):
        def __init__(self, *a, **kw):
            kw["born_machine"] = JQBM(n, ansatz_layers=2, dtype=jnp.complex128)
            super().__init__(*a, dtype=jnp.float64, **kw)
            self.born_params = jnp.asarray(theta)
            self.classifier_vars = made["clf0"] = _off_zero(self.classifier_vars)
            made["j"] = self

    class T(AdversarialVariationalInference):
        def __init__(self, *a, born_machine, **kw):
            qbm = QuantumBornMachine(n, 2, dtype=F64, device="cpu")
            super().__init__(*a, born_machine=qbm, dtype=F64, **kw)
            self.born_params = params_from_jax(theta, device="cpu", dtype=F64)
            self.classifier_params, _ = classifier_from_flax(
                _np64(made["clf0"]), self.classifier, "cpu", F64)
            made["t"] = self

        def train(self, *a, **kw):
            made.setdefault("seeds", []).append(kw["seed"])
            return super().train(*a, sampler=tsites.torch_sampler, **kw)

    monkeypatch.setattr(jscale, "AdversarialVariationalInference", J)
    monkeypatch.setattr(tscale, "AdversarialVariationalInference", T)
    kw = dict(num_qubits=n, layers=2, objective="adversarial", lr_phases=phases, seed=3,
              verbose=False, adv_batch_size=16, adv_k_classifier=k_d)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "categorical", jsites.jax_categorical)
        jout = jscale.run_scale_experiment(**kw)
    tout = tscale.run_scale_experiment(device="cpu", **kw)
    assert made["seeds"] == [3, 3 + 7919]
    assert made["t"].classifier.hidden_dims == tuple(made["j"].classifier.hidden_dims) == (32, 16)
    for key in HISTORY_KEYS:
        np.testing.assert_allclose(tout["history"][key], jout["history"][key], rtol=1e-7,
                                   atol=1e-12, err_msg=key)
    assert tout["model"].best_tvd_ == pytest.approx(jout["model"].best_tvd_, rel=1e-7)
    np.testing.assert_allclose(tout["model"].born_params.numpy(),
                               np.asarray(jout["model"].born_params), atol=1e-7)
    assert set(tout) == set(jout)


def test_bce_gradient_at_a_zero_logit():
    """At a logit of exactly 0 the port's BCE gradient is (σ(0) - y)/N; the
    JAX engine's form (``engines/advi.py:241-244``, written out here) gives
    -y/N, through its subgradients of the clip (½) and of |0| (+1). Away
    from 0 the two agree."""
    labels = np.array([[1.0], [0.0], [1.0], [0.0]])

    def jax_form(lg):
        return jnp.mean(jnp.clip(lg, 0, None) - lg * labels + jnp.log1p(jnp.exp(-jnp.abs(lg))))

    for logits, want_port in ((np.zeros((4, 1)), (0.5 - labels) / 4), (np.full((4, 1), 0.3), None)):
        g_jax = np.asarray(jax.grad(jax_form)(jnp.asarray(logits)))
        lt = torch.as_tensor(logits).requires_grad_(True)
        torch.nn.functional.binary_cross_entropy_with_logits(lt, torch.as_tensor(labels)).backward()
        if want_port is None:
            np.testing.assert_allclose(lt.grad.numpy(), g_jax, rtol=0, atol=1e-15)
        else:
            np.testing.assert_allclose(lt.grad.numpy(), want_port, rtol=0, atol=1e-15)
            np.testing.assert_allclose(g_jax, -labels / 4, rtol=0, atol=1e-15)


def test_multinomial_sampler_draws_from_the_distribution():
    p = torch.tensor([0.1, 0.0, 0.6, 0.3], dtype=F64)
    a = multinomial_sampler(p, 20000, torch.Generator().manual_seed(0))
    b = multinomial_sampler(p, 20000, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.dtype == torch.int64
    freq = torch.bincount(a, minlength=4).double() / 20000
    torch.testing.assert_close(freq, p, rtol=0, atol=0.015)
    assert int(freq[1]) == 0


def test_sprinkler_adversarial_runner_returns_the_jax_runner_keys():
    cfg = AdversarialConfig(num_epochs=20)
    out = run_sprinkler_experiment(cfg, verbose=False, device="cpu")
    jout = j_run(JAdvConfig(num_epochs=20), verbose=False)
    assert set(out) == set(jout)
    assert out["config"] == jout["config"]
    assert set(out["history"]) >= set(HISTORY_KEYS)
    assert len(out["history"]["tvd"]) == 20 and 0.0 <= out["final_tvd"] <= 1.0
    model = out["model"]
    assert model.classifier_input_dim == 4 and model.classifier.hidden_dims == (32, 16)
    assert model.best_tvd_ == pytest.approx(min(out["history"]["tvd"]))
    with pytest.raises(NotImplementedError, match="A11"):
        run_sprinkler_experiment(cfg, verbose=False, plot_path="x.png", device="cpu")
    eng = AdversarialVariationalInference(get_sprinkler_network(), *SPRINKLER[:1], ["W"],
                                          device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        eng.train({"W": 1}, 1, 4, 0.1, 0.1, checkpoint_path="c")
