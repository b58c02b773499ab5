"""The port's sampled-KSD engine and runner against the JAX package's, on
the same shots.

The engine test replays the JAX engine's key chain: per epoch ``k, sub =
split(k)``, then the uniforms ``uniform(sub, (M,))`` (flat) or, for
two-stage sampling, ``key_r, key_c = split(sub)`` and one uniform vector
each. The port's engine gets them through ``sampler=``, and the JAX
engine's own indices are recorded by a ``jax.debug.callback`` around its
samplers (the JAX package is unchanged): the port's indices must equal
them at every epoch, except at a rounding tie (a uniform within 1e-6 of
the CDF step between the two indices: both CDFs are float32, summed in
other orders), of which a run may have two; the port then goes on with the
JAX engine's shots. Both engines start from the same θ (a float64 Born machine;
the JAX one in complex128), and both cast q to float32, so the scores, the
Gram and the surrogate are float32 on both sides: the loss, TVD and
gradient-norm histories and the best TVD are held at 2e-5 relative, a
float32 tolerance that leaves room for another summation order in a
48-sample Gram; the final θ at 1e-5 absolute, 2e-4 of one Adam step at lr
0.05, since Adam's normalisation turns float32 round-off in a near-zero
gradient component into a larger step difference.

The runner test patches both engines to the same fixed indices (at n=4 the
JAX engine's flat sampler is ``jax.random.categorical``, whose draws no
uniform replays), as ``tests/test_torch_advi.py`` does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tensornetworks_tpu.engines as jengines
from tensornetworks_tpu.engines import sampled as jsampled
from tensornetworks_tpu.engines.sampled import SampledKSDVariationalInference as JSKSD
from tensornetworks_tpu.models import ClassicalBornMachine as JCBM
from tensornetworks_tpu.models import QuantumBornMachine as JQBM
from tensornetworks_tpu.runners import scale as jscale
from tensornetworks_tpu_torch.core import get_random_chain_network
from tensornetworks_tpu_torch.engines import SampledKSDVariationalInference
from tensornetworks_tpu_torch.interop import params_from_jax
from tensornetworks_tpu_torch.models import ClassicalBornMachine, QuantumBornMachine
from tensornetworks_tpu_torch.ops.kernels import precision as kp
from tensornetworks_tpu_torch.runners import scale as tscale
from tensornetworks_tpu_torch.sim.sampling import sample_indices, sample_indices_2d, step_distances

F64 = torch.float64
RTOL, THETA_ATOL = 2e-5, 1e-5
HISTORY_KEYS = ("loss_ksd", "tvd", "grad_norm")


class _Replay:
    """The JAX engine's uniforms, epoch by epoch, as the port's sampler. Each
    epoch it draws the port's own indices and holds them against the JAX
    engine's (``jax_indices``); a sample may differ only at a rounding tie
    (its uniform within 1e-6 of the CDF step between the two indices, in
    float64), and the JAX indices are returned, so that both runs go on
    with the same shots."""

    def __init__(self, seed, epochs, M, two_stage, jax_indices):
        k = jax.random.PRNGKey(seed)
        self.uniforms = []
        for _ in range(epochs):
            k, sub = jax.random.split(k)
            keys = jax.random.split(sub) if two_stage else [sub]
            self.uniforms.append([torch.as_tensor(np.array(
                jax.random.uniform(kk, (M,), dtype=jnp.float32))) for kk in keys])
        self.jax_indices = jax_indices
        self.epoch = self.ties = 0

    def __call__(self, P, num_samples, generator):
        u = self.uniforms[self.epoch]
        want = torch.as_tensor(self.jax_indices[self.epoch], dtype=torch.int64)
        self.epoch += 1
        if P.ndim == 1:
            got = sample_indices(P, *u)
        else:
            got = sample_indices_2d(P, *u)[0]
        dist = step_distances(P, got, want, *u)
        assert (dist <= 1e-6).all(), f"indices differ off a rounding tie: {dist}"
        self.ties += dist.size
        if P.ndim == 1:
            return want
        return want, want // P.shape[1], want % P.shape[1]


def _record_jax_indices(monkeypatch):
    """Wrap the JAX engine's samplers so that each epoch's indices reach the
    host, in order."""
    seen = []

    def record(idx):
        jax.debug.callback(lambda i: seen.append(np.asarray(i).copy()), idx, ordered=True)

    def flat(key, probs, num_samples, eps=1e-10):
        idx = jsampled_orig["flat"](key, probs, num_samples, eps)
        record(idx)
        return idx

    def two_stage(key, P, num_samples, eps=1e-10):
        out = jsampled_orig["2d"](key, P, num_samples, eps)
        record(out[0])
        return out

    jsampled_orig = {"flat": jsampled.sample_indices, "2d": jsampled.sample_indices_2d}
    monkeypatch.setattr(jsampled, "sample_indices", flat)
    monkeypatch.setattr(jsampled, "sample_indices_2d", two_stage)
    return seen


def _problem(n, seed=1):
    bn = get_random_chain_network(n + 1, seed=seed)
    latent = [f"V{i}" for i in range(n)]
    obs = {f"V{n}": 1}
    return bn, latent, obs


def _jax_network(n, seed=1):
    from tensornetworks_tpu.core import get_random_chain_network as j_chain

    return j_chain(n + 1, seed=seed)


CASES = {
    "flat12-loo": dict(n=12, sampling="flat", baseline="loo"),
    "two_stage5-loo-reuse": dict(n=5, sampling="two_stage", baseline="loo", reuse=True),
    "two_stage5-mean": dict(n=5, sampling="two_stage", baseline="mean"),
    "two_stage5-none-reuse": dict(n=5, sampling="two_stage", baseline="none", reuse=True),
    "two_stage5-cv": dict(n=5, sampling="two_stage", baseline="cv"),
    "two_stage5-loo-chunked": dict(n=5, sampling="two_stage", baseline="loo", chunk=2),
    # A table's unsampled outcomes get the gradient -q_j·(2/M)·Σ(w_i - b_i),
    # and the loo and mean baselines make that sum 0 up to round-off, which
    # Adam then scales to full steps of either sign: "none" keeps it finite.
    "classical5-none": dict(n=5, sampling="two_stage", baseline="none", born="classical"),
    "adjoint6-loo": dict(n=6, sampling="two_stage", baseline="loo", born="adjoint"),
}


def _born_machines(case, n, layers):
    born = case.get("born", "quantum")
    if born == "classical":
        return JCBM(n, dtype=jnp.float64), ClassicalBornMachine(n, dtype=F64, device="cpu")
    if born == "adjoint":
        return (JQBM(n, layers, dtype=jnp.complex128, backend="blocked", block=4,
                     grad_method="adjoint"),
                QuantumBornMachine(n, layers, dtype=F64, device="cpu", block=4,
                                   grad_method="adjoint"))
    return JQBM(n, layers, dtype=jnp.complex128), QuantumBornMachine(n, layers, dtype=F64,
                                                                     device="cpu")


def _train_pair(monkeypatch, case, epochs=6, M=48, layers=2, seed=3, chunk=None):
    n = case["n"]
    bn, latent, obs = _problem(n)
    post = bn.posterior_vector(latent, obs)
    jbm, tbm = _born_machines(case, n, layers)
    theta = 0.3 * np.random.default_rng(n).normal(size=tbm.num_params)
    kw = dict(num_samples=M, seed=seed, sampling=case["sampling"],
              grad_baseline=case["baseline"], base_kernel_length_scale="auto")
    jeng = JSKSD(_jax_network(n), latent, list(obs), born_machine=jbm, **kw)
    teng = SampledKSDVariationalInference(bn, latent, list(obs), born_machine=tbm, device="cpu",
                                          **kw)
    if case.get("born") == "classical":
        jeng.params = {"table": jnp.asarray(theta)}
    else:
        jeng.params = jnp.asarray(theta)
    teng.params = params_from_jax(theta, device="cpu", dtype=F64)
    train = dict(num_epochs=epochs, lr_born_machine=0.05, verbose=False,
                 true_posterior_for_tvd=post, chunk_epochs=chunk,
                 reuse_loss_forward_for_eval=case.get("reuse", False))
    with monkeypatch.context() as m:
        jseen = _record_jax_indices(m)
        hj = jeng.train(obs, **train)
    replay = _Replay(seed, epochs, M, case["sampling"] == "two_stage", jseen)
    ht = teng.train(obs, sampler=replay, **train)
    assert len(jseen) == replay.epoch == epochs
    assert replay.ties <= 2, f"{replay.ties} rounding ties in {epochs * M} shots"
    return hj, ht, jeng, teng


def _final_theta(jeng, teng):
    j = jeng.params["table"] if isinstance(jeng.params, dict) else jeng.params
    return teng.params.numpy(), np.asarray(j)


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_jax_on_replayed_uniforms(monkeypatch, name):
    case = CASES[name]
    hj, ht, jeng, teng = _train_pair(monkeypatch, case, chunk=case.get("chunk"))
    for key in HISTORY_KEYS:
        np.testing.assert_allclose(ht[key], hj[key], rtol=RTOL, atol=1e-9, err_msg=key)
    assert teng.best_epoch_ == jeng.best_epoch_
    assert teng.best_tvd_ == pytest.approx(jeng.best_tvd_, rel=RTOL)
    assert ht["num_skipped_updates"] == hj["num_skipped_updates"] == 0
    t, j = _final_theta(jeng, teng)
    np.testing.assert_allclose(t, j, rtol=0, atol=THETA_ATOL)
    assert ht["loss_ksd"][0] != ht["loss_ksd"][-1]
    if case.get("chunk"):
        assert "epochs_per_sec_steady" in ht
        # The same run in one chunk gives the same results.
        _, single, _, teng1 = _train_pair(monkeypatch, case, chunk=None)
        for key in HISTORY_KEYS:
            assert ht[key] == single[key], key
        assert torch.equal(teng.params, teng1.params)


def test_engine_constructor_choices_match_jax():
    """``auto`` sampling and gradient method, remat and the argument checks."""
    for n, two_stage in ((19, False), (20, True)):
        bn, latent, obs = _problem(n)
        eng = SampledKSDVariationalInference(bn, latent, list(obs), device="cpu")
        assert eng.sampling == ("two_stage" if two_stage else "flat")
    bn, latent, obs = _problem(26)
    eng = SampledKSDVariationalInference(bn, latent, list(obs), qbm_backend="blocked",
                                         device="cpu")
    assert (eng.born_machine.backend, eng.born_machine.grad_method) == ("blocked", "adjoint")
    eng = SampledKSDVariationalInference(bn, latent, list(obs), qbm_backend="blocked",
                                         qbm_grad_method="autodiff", device="cpu")
    assert (eng.born_machine.backend, eng.born_machine.grad_method) == ("blocked", "autodiff")
    bn, latent, obs = _problem(4)
    for kw in (dict(sampling="gumbel"), dict(grad_baseline="median")):
        with pytest.raises(ValueError):
            SampledKSDVariationalInference(bn, latent, list(obs), device="cpu", **kw)


@pytest.fixture
def kernel_precision():
    """Sets the kernel precision for machines built in the test; restores it."""
    old = kp._kernel_precision()
    yield kp.set_kernel_precision
    kp.set_kernel_precision(old)


@pytest.mark.parametrize("case,want", [
    ("auto", ("circuit2d_grid", "autodiff")), ("autodiff", ("circuit2d_grid", "autodiff")),
    ("high", ("blocked", "adjoint")), ("float64", ("blocked", "adjoint")),
    ("adjoint", ("blocked", "adjoint")), ("blocked", ("blocked", "adjoint")),
    ("bn_structured", ("circuit2d_grid", "autodiff"))])
@pytest.mark.parametrize("n", [26, 28])
def test_wide_machines_take_the_gate_path_where_it_runs(n, case, want, kernel_precision):
    """From 26 qubits ``qbm_grad_method="auto"`` leaves an FP32 machine under
    ``highest`` to the grid kernels' gate path (autograd into its adjoint),
    and takes the blocked adjoint where the gate path cannot run the
    machine (``high``, float64) or where it is asked for (an explicit
    ``qbm_grad_method="adjoint"`` or ``qbm_backend="blocked"``). The
    machines allocate no state when built."""
    kernel_precision("high" if case == "high" else "highest")
    kw = {"autodiff": dict(qbm_grad_method="autodiff"), "float64": dict(dtype=torch.float64),
          "adjoint": dict(qbm_grad_method="adjoint"),
          "blocked": dict(qbm_backend="blocked"),
          "bn_structured": dict(qbm_ansatz_type="bn_structured")}.get(case, {})
    bn, latent, obs = _problem(n)
    eng = SampledKSDVariationalInference(bn, latent, list(obs), device="cpu", **kw)
    assert (eng.born_machine.backend, eng.born_machine.grad_method) == want
    assert eng.sampling == "two_stage"


def test_progress_print_has_no_best_tvd_without_a_posterior(capsys):
    """Every tenth chunk prints progress; without a posterior the best TVD
    is not printed (the JAX engine prints ``best_tvd=inf``, ADVICE.md)."""
    bn, latent, obs = _problem(4)
    eng = SampledKSDVariationalInference(bn, latent, list(obs), num_samples=16, device="cpu")
    eng.train(obs, num_epochs=20, lr_born_machine=0.05, chunk_epochs=2)
    out = capsys.readouterr().out
    assert "[chunk] 20/20 epochs" in out and "best_tvd" not in out
    eng.train(obs, num_epochs=20, lr_born_machine=0.05, chunk_epochs=2,
              true_posterior_for_tvd=bn.posterior_vector(latent, obs))
    assert "best_tvd=0." in capsys.readouterr().out


class _FixedIndices:
    """The same indices at every draw, for both runners."""

    def __init__(self, M, size, seed=0):
        self.idx = np.random.default_rng(seed).integers(0, size, size=M)
        self.calls = 0

    def jax_categorical(self, key, logits, axis=-1, shape=None):
        self.calls += 1
        return jnp.asarray(self.idx, dtype=jnp.int32)

    def torch_sampler(self, P, num_samples, generator):
        assert P.ndim == 1 and num_samples == self.idx.size
        self.calls += 1
        return torch.as_tensor(self.idx)


def test_scale_runner_sampled_matches_the_jax_runner(monkeypatch):
    """``run_scale_experiment(objective="sampled-ksd")`` at n=4 against the
    JAX runner, both engines from the same θ (float64 Born machines) on the
    same fixed indices; the runners pick the rest (hardware_efficient, clip
    10, the auto length scale, the TVD tracked)."""
    n, layers, M, epochs = 4, 2, 24, 8
    theta = 0.3 * np.random.default_rng(0).normal(size=3 * layers * n)
    jfix, tfix = _FixedIndices(M, 2**n), _FixedIndices(M, 2**n)

    class J(JSKSD):
        def __init__(self, *a, **kw):
            super().__init__(*a, born_machine=JQBM(n, layers, dtype=jnp.complex128), **kw)
            self.params = jnp.asarray(theta)

    class T(SampledKSDVariationalInference):
        def __init__(self, *a, **kw):
            assert kw["qbm_ansatz_type"] == "hardware_efficient" and kw["num_samples"] == M
            super().__init__(*a, born_machine=QuantumBornMachine(n, layers, dtype=F64,
                                                                 device="cpu"), **kw)
            self.params = params_from_jax(theta, device="cpu", dtype=F64)

        def train(self, *a, **kw):
            return super().train(*a, sampler=tfix.torch_sampler, **kw)

    monkeypatch.setattr(jengines, "SampledKSDVariationalInference", J)
    monkeypatch.setattr(tscale, "SampledKSDVariationalInference", T)
    kw = dict(num_qubits=n, layers=layers, num_epochs=epochs, lr=0.05, objective="sampled-ksd",
              seed=2, verbose=False, num_samples=M, grad_baseline="mean")
    with monkeypatch.context() as m:
        m.setattr(jax.random, "categorical", jfix.jax_categorical)
        jout = jscale.run_scale_experiment(**kw)
    tout = tscale.run_scale_experiment(device="cpu", **kw)
    assert tfix.calls == epochs and jfix.calls >= 1
    for key in HISTORY_KEYS:
        np.testing.assert_allclose(tout["history"][key], jout["history"][key], rtol=RTOL,
                                   atol=1e-9, err_msg=key)
    assert tout["model"].best_tvd_ == pytest.approx(jout["model"].best_tvd_, rel=RTOL)
    assert tout["model"].length_scale == jout["model"].length_scale == 0.25
    np.testing.assert_allclose(tout["model"].params.numpy(), np.asarray(jout["model"].params),
                               rtol=0, atol=THETA_ATOL)
    assert set(tout) == set(jout) and set(tout["history"]) == set(jout["history"])
    with pytest.raises(ValueError, match="hardware_efficient"):
        tscale.run_scale_experiment(num_qubits=3, layers=1, num_epochs=1, objective="sampled-ksd",
                                    ansatz="bn_structured", device="cpu")


def test_sampling_throughput_returns_the_jax_keys():
    jout = jscale.run_sampling_throughput(4, layers=1, num_samples=64, verbose=False)
    tout = tscale.run_sampling_throughput(4, layers=1, num_samples=64, verbose=False,
                                          device="cpu")
    assert set(tout) == set(jout) and tout["num_qubits"] == 4 and tout["samples_per_sec"] > 0
