"""The port's classical KSD slice against the JAX package: the classical
Born machine (table with logits and with abs, conditional MLP with and
without LayerNorm), the classical KSD engine at n=3 (dense Gram) and n=13
(the Kronecker path, which runs the stein2d kernel's plain version), early
stopping, the conditional engine, the tensor bit codecs, the marginal
tables, the Sprinkler runner and the final report.

Float64 on the CPU. The JAX Born machine's Flax parameters are cast to
float64 and carried across by ``interop.flat_from_flax``. Tolerances:
1e-12 on single forwards, 1e-9 relative on engine histories and best TVDs
and 1e-9 absolute on the final table (summation order)."""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensornetworks_tpu.core import get_random_chain_network as j_chain
from tensornetworks_tpu.core import get_sprinkler_network as j_sprinkler
from tensornetworks_tpu.core.bits import jnp_bits_to_index, jnp_index_to_bits
from tensornetworks_tpu.engines import common as jcommon
from tensornetworks_tpu.engines.ksd import KSDVariationalInference as JKSD
from tensornetworks_tpu.models.born_classical import ClassicalBornMachine as JCBM
from tensornetworks_tpu.runners import reporting as jreporting
from tensornetworks_tpu.runners.sprinkler_ksd import run_sprinkler_ksd_experiment as j_run
from tensornetworks_tpu_torch.core import (get_random_chain_network, get_sprinkler_network,
                                           torch_bits_to_index, torch_index_to_bits)
from tensornetworks_tpu_torch.engines import common as tcommon
from tensornetworks_tpu_torch.engines import KSDVariationalInference
from tensornetworks_tpu_torch.interop import flat_from_flax
from tensornetworks_tpu_torch.models import ClassicalBornMachine
from tensornetworks_tpu_torch.runners import ClassicalKSDConfig, reporting as treporting
from tensornetworks_tpu_torch.runners import run_sprinkler_ksd_experiment

F64 = torch.float64
SPRINKLER = (["C", "S", "R"], {"W": 1})


def _np64(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float64), tree)


def _perturbed(tree, seed):
    """Flax parameters with noise on every leaf, so that biases and LayerNorm
    scales are not at their init values."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float64) + 0.1 * rng.normal(size=a.shape),
                        tree)


BM_CASES = {
    "table-logits": dict(use_logits=True),
    "table-abs": dict(use_logits=False),
    "mlp": dict(conditioning_dim=2, hidden_dims=[8, 5]),
    "mlp-layernorm": dict(conditioning_dim=2, hidden_dims=[8, 5], use_layer_norm=True),
    "mlp-abs-default-dims": dict(conditioning_dim=1, use_logits=False),
}


@pytest.mark.parametrize("case", list(BM_CASES))
def test_born_machine_matches_jax(case):
    cfg = BM_CASES[case]
    jbm = JCBM(4, dtype=jnp.float64, **cfg)
    tbm = ClassicalBornMachine(4, dtype=F64, device="cpu", **cfg)
    pj = _perturbed(jbm.init(jax.random.PRNGKey(1)), 1)
    pt = flat_from_flax(pj, tbm.layout, "cpu", F64)
    assert pt.shape == (tbm.num_params,)
    pj = jax.tree.map(jnp.asarray, pj)
    d = cfg.get("conditioning_dim", 0)
    conds = [None] if d == 0 else [np.linspace(-1.0, 1.0, d),
                                   np.random.default_rng(2).normal(size=(3, d))]
    for x in conds:
        xj = None if x is None else jnp.asarray(x)
        for name in ("probs", "log_probs", "entropy"):
            want = np.asarray(getattr(jbm, name)(pj, xj))
            got = getattr(tbm, name)(pt, x).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, err_msg=name)
    # Gradients through the forward agree too (the engines' steps use them).
    v = np.random.default_rng(3).normal(size=16)
    x1 = conds[0]
    gj = jax.grad(lambda p: jbm.probs(p, None if x1 is None else jnp.asarray(x1)) @ v)(pj)
    p = pt.clone().requires_grad_(True)
    (tbm.probs(p, x1) @ torch.as_tensor(v)).backward()
    np.testing.assert_allclose(p.grad.numpy(),
                               flat_from_flax(_np64(gj), tbm.layout, "cpu", F64).numpy(),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", ["zero", "small_random", "uniform", "random"])
def test_table_init_methods(method):
    bm = ClassicalBornMachine(12, init_method=method, dtype=F64, device="cpu")
    t = bm.init(torch.Generator().manual_seed(0))
    mean, std = {"zero": (0.0, 0.0), "small_random": (0.0, 0.1),
                 "uniform": (np.log(1 / 4096), 0.01), "random": (0.0, 1.0)}[method]
    assert t.shape == (4096,) and t.dtype == F64
    assert abs(float(t.mean()) - mean) <= 4 * std / 64 + 1e-12
    assert abs(float(t.std()) - std) <= 0.05 * std + 1e-12
    again = bm.init(torch.Generator().manual_seed(0))
    assert torch.equal(t, again)


def test_mlp_init_is_xavier_uniform_with_zero_biases():
    bm = ClassicalBornMachine(6, conditioning_dim=2, use_layer_norm=True, dtype=F64,
                              device="cpu")
    assert bm.hidden_dims == (64, 32)
    v = bm.views(bm.init(torch.Generator().manual_seed(0)))
    for i, (fan_out, fan_in) in enumerate([(64, 2), (32, 64), (64, 32)]):
        w = v[f"Dense_{i}.weight"]
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        assert w.shape == (fan_out, fan_in)
        assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.8 * limit
        assert not v[f"Dense_{i}.bias"].any()
    assert torch.equal(v["LayerNorm_0.scale"], torch.ones(64, dtype=F64))
    assert not v["LayerNorm_1.bias"].any()


def test_dropout_and_fixed_probs():
    bm = ClassicalBornMachine(3, conditioning_dim=1, hidden_dims=[4096], dropout_rate=0.25,
                              dtype=F64, device="cpu")
    p = bm.init(torch.Generator().manual_seed(0))
    x = torch.tensor([1.0], dtype=F64)
    h = torch.relu(torch.nn.functional.linear(x, bm.views(p)["Dense_0.weight"],
                                              bm.views(p)["Dense_0.bias"]))
    from tensornetworks_tpu_torch.models.born_classical import dropout
    d = dropout(h, 0.25, torch.Generator().manual_seed(1))
    kept = d != 0
    torch.testing.assert_close(d[kept], h[kept] / 0.75, rtol=0, atol=1e-15)
    assert abs(float(kept[h != 0].double().mean()) - 0.75) < 0.05
    with pytest.raises(ValueError, match="generator"):
        bm.probs(p, x, train=True)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert torch.equal(bm.probs(p, x, train=True, generator=g1),
                       bm.probs(p, x, train=True, generator=g2))
    assert not torch.equal(bm.probs(p, x, train=True, generator=g1), bm.probs(p, x))
    fixed = torch.full((8,), 0.125, dtype=F64)
    bm.set_fixed_probs(fixed)
    assert torch.equal(bm.probs(p, x), fixed)
    assert bm.get_prob_dict(p, x)[(1, 0, 1)] == 0.125
    bm.clear_fixed_probs()
    assert not torch.equal(bm.probs(p, x), fixed)
    with pytest.raises(ValueError):
        bm.probs(p)
    with pytest.raises(ValueError):
        ClassicalBornMachine(3, device="cpu").probs(torch.zeros(8), x)


def test_cosine_schedule_steps_per_epoch_matches_jax():
    s_j = jcommon.cosine_lr_schedule(0.2, 7, steps_per_epoch=3)
    s_t = tcommon.cosine_lr_schedule(0.2, 7, steps_per_epoch=3)
    for c in range(25):
        assert abs(float(s_t(torch.tensor(c))) - float(s_j(c))) < 1e-15


def test_bit_codecs_match_jax():
    idx = np.array([0, 5, 6, 63, 17])
    want = np.asarray(jnp_index_to_bits(jnp.asarray(idx), 6, dtype=jnp.float64))
    got = torch_index_to_bits(torch.as_tensor(idx), 6, F64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(torch_bits_to_index(got).numpy(),
                                  np.asarray(jnp_bits_to_index(jnp.asarray(want))))


@pytest.mark.parametrize("names", [["C", "S", "R"], ["R", "C"], ["W"], ["S", "W", "C", "R"]])
def test_marginal_table_and_prior_match_jax(names):
    tbn, jbn = get_sprinkler_network(random_cpts=True, seed=4), j_sprinkler(True, seed=4)
    np.testing.assert_allclose(tbn.marginal_table(names), jbn.marginal_table(names),
                               rtol=0, atol=1e-15)
    assert tbn.get_prior_distribution(names) == pytest.approx(
        jbn.get_prior_distribution(names), abs=1e-15)
    chain_t, chain_j = get_random_chain_network(9, seed=1), j_chain(9, seed=1)
    names = ["V7", "V2", "V4"]
    np.testing.assert_allclose(chain_t.marginal_table(names), chain_j.marginal_table(names),
                               rtol=0, atol=1e-15)


def _engines(bn_t, bn_j, latent, obs, cfg, seed=0):
    jeng = JKSD(bn_j, latent, list(obs), cfg, dtype=jnp.float64, seed=seed)
    jeng.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jeng.params)
    teng = KSDVariationalInference(bn_t, latent, list(obs), cfg, dtype=F64, seed=seed,
                                   device="cpu")
    teng.params = flat_from_flax(_np64(jeng.params), teng.born_machine.layout, "cpu", F64)
    return jeng, teng


def _assert_histories_match(ht, hj, keys=("loss_ksd", "tvd", "grad_norm", "entropy")):
    for key in keys:
        assert len(ht[key]) == len(hj[key]), key
        np.testing.assert_allclose(ht[key], hj[key], rtol=1e-9, err_msg=key)


@pytest.mark.parametrize("n", [3, 13])  # dense Gram / Kronecker path with stein2d
def test_ksd_engine_matches_jax(n):
    latent, obs = [f"V{i}" for i in range(n)], {f"V{n}": 1}
    jeng, teng = _engines(get_random_chain_network(n + 1, seed=0), j_chain(n + 1, seed=0),
                          latent, obs, {"conditioning_dim": 0})
    assert teng.build_operator(obs).dense == (n <= 12)
    post = get_random_chain_network(n + 1, seed=0).posterior_vector(latent, obs)
    kw = dict(num_epochs=40, lr_born_machine=0.05, verbose=False, true_posterior_for_tvd=post,
              gradient_clip_norm=5.0, entropy_weight=1e-3)
    hj, ht = jeng.train(obs, **kw), teng.train(obs, chunk_epochs=9, **kw)
    _assert_histories_match(ht, hj)
    assert teng.best_tvd_ == pytest.approx(jeng.best_tvd_, rel=1e-9)
    assert teng.best_epoch_ == jeng.best_epoch_
    np.testing.assert_allclose(teng.params.numpy(), np.asarray(jeng.params["table"]), rtol=0,
                               atol=1e-9)
    # Restored in fixed-probs mode: the distribution of the best epoch.
    np.testing.assert_allclose(teng.born_machine.probs(teng.params).numpy(),
                               np.asarray(jeng.born_machine.probs(jeng.params)), atol=1e-9)
    assert ht["num_skipped_updates"] == 0 and "epochs_per_sec_steady" in ht
    assert ht["loss_ksd"][-1] < ht["loss_ksd"][0]


def test_early_stopping_matches_jax():
    """Patience 5 over 2000 epochs at Sprinkler: the run stops at JAX's
    epoch, with JAX's history length, best epoch and best TVD."""
    latent, obs = SPRINKLER
    jeng, teng = _engines(get_sprinkler_network(), j_sprinkler(), latent, obs,
                          {"conditioning_dim": 0})
    post, _ = get_sprinkler_network().get_true_posterior(latent, obs)
    kw = dict(num_epochs=2000, lr_born_machine=0.05, verbose=False,
              true_posterior_for_tvd=post, patience=5, entropy_weight=1e-3)
    hj, ht = jeng.train(obs, **kw), teng.train(obs, **kw)
    assert 300 < len(hj["tvd"]) < 2000
    _assert_histories_match(ht, hj)
    assert teng.best_epoch_ == jeng.best_epoch_
    assert teng.best_tvd_ == pytest.approx(jeng.best_tvd_, rel=1e-9)


@pytest.mark.parametrize("layer_norm", [False, True])
def test_conditional_engine_without_dropout_matches_jax(layer_norm):
    latent, obs = SPRINKLER
    cfg = {"conditioning_dim": 1, "dropout_rate": 0.0, "hidden_dims": [16, 8],
           "use_layer_norm": layer_norm}
    jeng, teng = _engines(get_sprinkler_network(), j_sprinkler(), latent, obs, cfg)
    post, _ = get_sprinkler_network().get_true_posterior(latent, obs)
    kw = dict(num_epochs=30, lr_born_machine=0.01, verbose=False, true_posterior_for_tvd=post)
    hj, ht = jeng.train(obs, **kw), teng.train(obs, **kw)
    _assert_histories_match(ht, hj)
    assert teng.best_epoch_ == jeng.best_epoch_
    assert teng.get_prob_dict() == pytest.approx(jeng.get_prob_dict(), abs=1e-9)


def test_dropout_engine_trains_and_restores():
    """With dropout (the shipped configuration) the masks come from the
    run's generator: the same seed gives the same run; the noisy-eval
    convention restores the best parameters' deterministic distribution."""
    latent, obs = SPRINKLER
    bn = get_sprinkler_network()
    post, _ = bn.get_true_posterior(latent, obs)
    runs = []
    for conv in ("deterministic", "deterministic", "train_noisy"):
        eng = KSDVariationalInference(bn, latent, list(obs), {"conditioning_dim": 1},
                                      dtype=F64, device="cpu")
        h = eng.train(obs, num_epochs=40, lr_born_machine=3e-3, verbose=False,
                      true_posterior_for_tvd=post, eval_convention=conv, seed=3)
        runs.append((h, eng))
    assert runs[0][0]["tvd"] == runs[1][0]["tvd"]
    eng = runs[2][1]
    assert runs[2][0]["tvd"] != runs[0][0]["tvd"]
    best = eng.born_machine.probs(eng.params, torch.tensor([1.0], dtype=F64))
    eng.born_machine.clear_fixed_probs()
    want = eng.born_machine.probs(eng.best_params_, torch.tensor([1.0], dtype=F64))
    torch.testing.assert_close(best, want, rtol=0, atol=1e-15)


def test_second_run_trains_the_parameters_again():
    """A run restores the best distribution in fixed-probs mode; the next
    run trains the parameters from where the last one ended."""
    latent, obs = SPRINKLER
    bn = get_sprinkler_network()
    post, _ = bn.get_true_posterior(latent, obs)
    eng = KSDVariationalInference(bn, latent, list(obs), {"conditioning_dim": 0}, dtype=F64,
                                  device="cpu")
    kw = dict(num_epochs=20, lr_born_machine=0.05, verbose=False, true_posterior_for_tvd=post)
    eng.train(obs, **kw)
    after_first = eng.params.clone()
    h = eng.train(obs, **kw)
    assert h["grad_norm"][0] > 0 and not torch.equal(eng.params, after_first)


def test_engine_names_what_is_not_ported(tmp_path):
    """The engine's hooks that were not ported before ROADMAP A11 now run (a
    checkpoint file, a profiler trace); resuming needs chunks; the rest
    raises as in the JAX engine."""
    latent, obs = SPRINKLER
    eng = KSDVariationalInference(get_sprinkler_network(), latent, list(obs),
                                  {"conditioning_dim": 0}, device="cpu")
    with pytest.raises(ValueError, match="chunk_epochs"):
        eng.train(obs, num_epochs=1, lr_born_machine=0.1, verbose=False,
                  resume_state_path=str(tmp_path / "r"))
    eng.train(obs, num_epochs=1, lr_born_machine=0.1, verbose=False,
              checkpoint_path=str(tmp_path / "c"), profile_dir=str(tmp_path / "p"))
    assert (tmp_path / "c").exists() and list((tmp_path / "p").iterdir())
    with pytest.raises(ValueError):
        eng.train(obs, num_epochs=1, lr_born_machine=0.1, eval_convention="other")
    with pytest.raises(ValueError):
        eng.train({"X": 1}, num_epochs=1, lr_born_machine=0.1)


def test_sprinkler_ksd_runner_returns_the_jax_runner_keys(tmp_path):
    cfg = ClassicalKSDConfig(num_epochs=30)
    out = run_sprinkler_ksd_experiment(cfg, verbose=False, device="cpu")
    jout = j_run(__import__("tensornetworks_tpu.runners.configs", fromlist=["x"])
                 .ClassicalKSDConfig(num_epochs=30), verbose=False)
    assert set(out) == set(jout)
    assert out["config"] == jout["config"]
    assert out["true_posterior"] == pytest.approx(jout["true_posterior"], abs=1e-15)
    assert set(out["history"]) >= {"loss_ksd", "tvd", "grad_norm", "entropy"}
    assert 0.0 <= out["final_tvd"] <= 1.0
    assert out["model"].born_machine.conditioning_dim == 1
    plot = tmp_path / "ksd.png"
    run_sprinkler_ksd_experiment(ClassicalKSDConfig(num_epochs=3), verbose=False,
                                 plot_path=str(plot), device="cpu")
    assert plot.exists()


def test_print_final_report_matches_jax():
    latent, obs = SPRINKLER
    true, _ = get_sprinkler_network().get_true_posterior(latent, obs)
    learned = {k: v * 0.9 for k, v in true.items()}
    outs = []
    for fn in (treporting.print_final_report, jreporting.print_final_report):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(latent, obs, true, learned, 0.05)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "0.050000" in outs[0]
