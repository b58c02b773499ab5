"""The PyTorch port's core modules (bits, metrics, Bayesian networks, Hamming
helpers) against the JAX package, and the port's import hygiene.

Tolerances: the networks are host float64 numpy in both packages, built from
the same numpy RNG draws, so tables agree to 1e-12 (the posterior) or
exactly."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tensornetworks_tpu.core import bayes_net as jbn
from tensornetworks_tpu.core import bits as jbits
from tensornetworks_tpu.core import metrics as jmetrics
from tensornetworks_tpu.ops import hamming as jhamming
from tensornetworks_tpu.ops.stein import score_table as j_score_table
from tensornetworks_tpu_torch.core import bayes_net as tbn
from tensornetworks_tpu_torch.core import bits as tbits
from tensornetworks_tpu_torch.core import metrics as tmetrics
from tensornetworks_tpu_torch.ops import hamming as thamming
from tensornetworks_tpu_torch.ops.stein import score_table as t_score_table

PORT = Path(__file__).resolve().parents[1] / "tensornetworks_tpu_torch"


def test_sprinkler_posterior_matches_jax():
    latent, obs = ["C", "S", "R"], {"W": 1}
    jp, jobs = jbn.get_sprinkler_network().get_true_posterior(latent, obs)
    tp, tobs = tbn.get_sprinkler_network().get_true_posterior(latent, obs)
    assert jp.keys() == tp.keys()
    np.testing.assert_allclose([tp[k] for k in jp], [jp[k] for k in jp], atol=1e-12, rtol=0)
    assert abs(jobs - tobs) < 1e-12


@pytest.mark.parametrize("seed", [0, 3])
def test_random_sprinkler_posterior_vector_matches_jax(seed):
    latent, obs = ["C", "S", "R"], {"W": 0}
    j = jbn.get_sprinkler_network(random_cpts=True, seed=seed).posterior_vector(latent, obs)
    t = tbn.get_sprinkler_network(random_cpts=True, seed=seed).posterior_vector(latent, obs)
    np.testing.assert_allclose(t, j, atol=1e-12, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_chain_network_tables_match_jax_at_n10(seed):
    n = 10
    latent, obs = [f"V{i}" for i in range(n)], {f"V{n}": 1}
    jt = jbn.get_random_chain_network(n + 1, seed=seed).conditional_joint_table(latent, obs)
    tt = tbn.get_random_chain_network(n + 1, seed=seed).conditional_joint_table(latent, obs)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(t_score_table(tt), j_score_table(jt))


def test_conditional_joint_marginalizes_like_jax():
    # Latents in a non-position order with a marginalized middle variable.
    latent, obs = ["V4", "V0", "V2"], {"V5": 0}
    jt = jbn.get_random_chain_network(6, seed=2).conditional_joint_table(latent, obs)
    tt = tbn.get_random_chain_network(6, seed=2).conditional_joint_table(latent, obs)
    np.testing.assert_array_equal(tt, jt)


def test_bayes_net_validation():
    bn = tbn.BayesianNetwork()
    bn.add_node("A", cpt={(): {0: 0.5, 1: 0.5}})
    with pytest.raises(ValueError, match="already exists"):
        bn.add_node("A", cpt={(): {0: 0.5, 1: 0.5}})
    with pytest.raises(ValueError, match="not found"):
        bn.add_node("B", cpt={(0,): {0: 1.0, 1: 0.0}}, parent_names=["Z"])
    with pytest.raises(ValueError, match="sum to 1"):
        bn.add_node("B", cpt={(): {0: 0.5, 1: 0.6}})
    with pytest.raises(ValueError, match="disjoint"):
        bn.conditional_joint_table(["A"], {"A": 1})


@pytest.mark.parametrize("n", [0, 1, 5])
def test_bits_match_jax(n):
    np.testing.assert_array_equal(tbits.all_bitstrings(n), jbits.all_bitstrings(n))
    rows = jbits.all_bitstrings(n)
    np.testing.assert_array_equal(tbits.bits_to_index(rows), jbits.bits_to_index(rows))
    assert tbits.generate_all_binary_outcomes(n) == jbits.generate_all_binary_outcomes(n)
    for v in range(n):
        assert tbits.flip_index(6, n, v) == jbits.flip_index(6, n, v)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    p, q = rng.dirichlet(np.ones(16)), rng.dirichlet(np.ones(16))
    p[3] = 0.0
    assert tmetrics.calculate_tvd(p, q) == jmetrics.calculate_tvd(p, q)
    d1, d2 = {(0,): 0.3, (1,): 0.7}, {(1,): 0.5, (2,): 0.5}
    assert tmetrics.calculate_tvd(d1, d2) == jmetrics.calculate_tvd(d1, d2)
    tp, tq = torch.as_tensor(p), torch.as_tensor(q)
    for tf, jf in ((tmetrics.tvd, jmetrics.tvd), (tmetrics.kl_divergence, jmetrics.kl_divergence)):
        np.testing.assert_allclose(float(tf(tp, tq)), float(jf(p, q)), rtol=1e-12)
    np.testing.assert_allclose(float(tmetrics.entropy(tp)), float(jmetrics.entropy(p)), rtol=1e-12)


@pytest.mark.parametrize("spec,n", [("auto", 3), ("auto", 16), ("auto", 18), ("auto", 24),
                                    (0.25, 7), (1.0, 0)])
def test_length_scale_and_decay_match_jax(spec, n):
    ls = thamming.resolve_length_scale(spec, n)
    assert ls == jhamming.resolve_length_scale(spec, n)
    assert thamming.decay_factor(n, ls) == jhamming.decay_factor(n, ls)


def test_length_scale_rejects_unknown_string():
    with pytest.raises(ValueError):
        thamming.resolve_length_scale("sharp", 4)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_port_module_imports_neither_jax_nor_the_jax_package(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "optax", "tensornetworks_tpu"), (
            f"{path.name} imports {name}")


def test_port_import_loads_no_jax_module():
    code = ("import sys, tensornetworks_tpu_torch, tensornetworks_tpu_torch.interop, "
            "tensornetworks_tpu_torch.runners; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'tensornetworks_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {**os.environ, "PYTHONPATH": str(PORT.parent)}
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_disables_tf32():
    import tensornetworks_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
