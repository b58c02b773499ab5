"""Distributed sampled KSD (``parallel/distributed_sampled.py``,
``engines/distributed_sampled.py``) after the JAX package's
tests/test_distributed_sampled.py.

One spawn of 4 gloo ranks on the CPU runs every case. The sharded sampler
is held against ``sample_indices_2d`` on the gathered matrix with the same
uniforms: the JAX package's (uniforms from its key, as it draws them) and
the port's, element for element; its gradient into the owning shard
against the single-device ``gather_2d`` gradient at 1e-12. The engine is
held against the port's single-device ``SampledKSDVariationalInference``
(two-stage, the same seed, so the same uniforms), which
tests/test_torch_sampled_engine.py holds against the JAX engine: with θ in
float64 the shots are the same, and the losses (float32 estimates) agree to
1e-5. The JAX spec's convergence case (slow there) runs at 4 qubits for
150 epochs here."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tensornetworks_tpu.sim.sampling import sample_indices_2d as jax_sample_indices_2d
from tensornetworks_tpu_torch.core import get_random_chain_network
from tensornetworks_tpu_torch.engines import SampledKSDVariationalInference
from tensornetworks_tpu_torch.parallel import spawn
from tensornetworks_tpu_torch.sim.sampling import gather_2d, sample_indices_2d

import torch_dist_ranks

SHARDS = (4, 2)
BASELINES = ("loo", "mean", "none", "cv")
M8 = 512


def _key_uniforms(key, M, dtype):
    """The uniforms JAX's sample_indices_2d draws from ``key``."""
    key_r, key_c = jax.random.split(key)
    return (np.asarray(jax.random.uniform(key_r, (M,), dtype=dtype)),
            np.asarray(jax.random.uniform(key_c, (M,), dtype=dtype)))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(3)
    P64 = rng.dirichlet(np.ones(1 << 8)).reshape(16, 16)
    u_r, u_c = _key_uniforms(jax.random.PRNGKey(17), M8, jnp.float32)
    u_r64, u_c64 = _key_uniforms(jax.random.PRNGKey(17), M8, jnp.float64)
    P6 = rng.dirichlet(np.ones(1 << 6)).reshape(8, 8)
    inp = {"P8": P64.astype(np.float32), "P8_64": P64, "u_r": u_r, "u_c": u_c,
           "u_r64": u_r64, "u_c64": u_c64, "P6": P6,
           "u6_r": rng.random(64), "u6_c": rng.random(64)}
    out = spawn(torch_dist_ranks.sampled_cases, 4, "gloo", "cpu", inp, timeout_s=150)
    return inp, out


@pytest.mark.parametrize("shards", SHARDS)
def test_distributed_sampler_matches_single_device(case, shards):
    inp, out = case
    P = torch.as_tensor(inp["P8"])
    u_r, u_c = torch.from_numpy(inp["u_r"].copy()), torch.from_numpy(inp["u_c"].copy())
    idx, r, c = sample_indices_2d(P, u_r, u_c)
    got_idx, got_q = out[f"P8/D{shards}"]
    np.testing.assert_array_equal(got_idx, idx.numpy())
    np.testing.assert_array_equal(got_q, gather_2d(P, r, c).numpy())


@pytest.mark.parametrize("shards", SHARDS)
def test_distributed_sampler_matches_jax_shots(case, shards):
    """float64: the JAX package's two-stage shots from a key, and the port's
    sharded sampler's from the uniforms that key gives."""
    inp, out = case
    want, r, c = jax_sample_indices_2d(jax.random.PRNGKey(17), jnp.asarray(inp["P8_64"]), M8)
    got_idx, got_q = out[f"P8_64/D{shards}"]
    np.testing.assert_array_equal(got_idx, np.asarray(want))
    np.testing.assert_array_equal(got_q, inp["P8_64"][np.asarray(r), np.asarray(c)])


@pytest.mark.parametrize("shards", SHARDS)
def test_distributed_sampler_gradient_flows_to_owning_shard(case, shards):
    """d Σ q_at / d P2 is the count of each (r, c) drawn: one per shot, into
    the shard that owns its row, equal to the single-device gradient."""
    inp, out = case
    idx, grad = out[f"grad/D{shards}"]
    P = torch.as_tensor(inp["P6"]).requires_grad_(True)
    ref_idx, r, c = sample_indices_2d(P.detach(), torch.as_tensor(inp["u6_r"]),
                                      torch.as_tensor(inp["u6_c"]))
    gather_2d(P, r, c).sum().backward()
    np.testing.assert_array_equal(idx, ref_idx.numpy())
    np.testing.assert_allclose(grad, P.grad.numpy(), rtol=0, atol=1e-12)
    counts = np.zeros(64)
    np.add.at(counts, idx, 1.0)
    np.testing.assert_array_equal(grad.reshape(-1), counts)


@pytest.mark.parametrize("baseline", BASELINES)
def test_distributed_sampled_engine_loss_parity(case, baseline):
    _, out = case
    n = 7
    bn = get_random_chain_network(n + 1, seed=2)
    latent, obs = [f"V{i}" for i in range(n)], {f"V{n}": 1}
    single = SampledKSDVariationalInference(
        bn, latent, [f"V{n}"], qbm_ansatz_layers=2, num_samples=256, seed=0,
        sampling="two_stage", grad_baseline=baseline, dtype=torch.float64, device="cpu")
    h = single.train(obs, num_epochs=25, lr_born_machine=0.05, verbose=False,
                     true_posterior_for_tvd=bn.posterior_vector(latent, obs),
                     reuse_loss_forward_for_eval=True)
    got = out[f"parity/{baseline}"]
    # The loss reads (est − s) + s in float32 (s the surrogate, from log q at
    # the shots): q in float64 from another executor can round to another
    # float32 at a shot, which moves the loss by an ulp of s, up to ~10 of
    # the loss's own.
    np.testing.assert_allclose(got["loss"], h["loss_ksd"], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got["tvd"], h["tvd"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got["best_tvd"], single.best_tvd_, rtol=1e-6)
    for theta in got["params_by_rank"][1:]:
        np.testing.assert_array_equal(theta, got["params_by_rank"][0])


def test_distributed_sampled_engine_chunked_matches_single_scan(case):
    _, out = case
    (loss_a, best_a), (loss_b, best_b) = out["chunked"]
    np.testing.assert_array_equal(loss_a, loss_b)
    assert best_a == best_b


def test_distributed_sampled_engine_converges(case):
    """bn_structured L=3 with the cv baseline reaches the JAX spec's TVD."""
    _, out = case
    assert out["converged_tvd"] < 0.15, out["converged_tvd"]
