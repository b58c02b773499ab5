"""dp-sharded amortized training (``AmortizedKSD.train(mesh=)`` and
``train_multi_seed(mesh=)``), after the JAX package's
tests/test_amortized_mesh.py.

One spawn of 4 gloo ranks on the CPU, a dp-only mesh: 8 observations (2 a
rank) and 8 seeds (2 a rank). The dp runs are held against the port's
single-device runs in the pytest process (float64 amortized to 1e-9;
float32 seeds to the JAX spec's rtol 1e-4, atol 5e-4), and the seeds also
against the JAX package's ``train_multi_seed`` from the same θ0 at that
tolerance."""

import itertools

import numpy as np
import pytest
import torch

from tensornetworks_tpu.core import get_sprinkler_network as j_sprinkler
from tensornetworks_tpu.engines.amortized import train_multi_seed as j_train_multi_seed
from tensornetworks_tpu_torch.core import get_random_chain_network, get_sprinkler_network
from tensornetworks_tpu_torch.engines import AmortizedKSD, train_multi_seed
from tensornetworks_tpu_torch.models import QuantumBornMachine
from tensornetworks_tpu_torch.parallel import spawn

import torch_dist_ranks

CFG = {"use_logits": True, "dropout_rate": 0.0}
OBSERVED = [f"V{i}" for i in range(3, 6)]


def _obs_grid(names):
    return [dict(zip(names, bits)) for bits in itertools.product((0, 1), repeat=len(names))]


@pytest.fixture(scope="module")
def case():
    qbm = QuantumBornMachine(3, ansatz_layers=2, device="cpu")
    poisoned = torch.stack([qbm.init(torch.Generator().manual_seed(k)) for k in range(4)])
    poisoned[0] = float("nan")
    inp = {"cfg": CFG, "observations": _obs_grid(OBSERVED), "poisoned": poisoned.numpy()}
    return inp, spawn(torch_dist_ranks.amortized_mesh_cases, 4, "gloo", "cpu", inp,
                      timeout_s=150)


def test_amortized_dp_sharded_matches_single_device(case):
    inp, out = case
    bn = get_random_chain_network(6, seed=3, num_observed=3)
    eng = AmortizedKSD(bn, [f"V{i}" for i in range(3)], OBSERVED, born_machine_config=CFG,
                       dtype=torch.float64, device="cpu")
    h = eng.train(inp["observations"], num_epochs=60, lr=1e-2, verbose=False, seed=0)
    got = out["amortized"]
    np.testing.assert_allclose(got["loss"], h["loss"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got["mean_tvd"], h["mean_tvd"], rtol=1e-9, atol=1e-11)
    assert got["best"] == pytest.approx(eng.best_mean_tvd_, rel=1e-9)
    for obs, q in zip(inp["observations"][:2], got["posteriors"]):
        np.testing.assert_allclose(q, eng.posterior_for(obs).numpy(), rtol=1e-8, atol=1e-10)
    for theta in got["params_by_rank"][1:]:
        np.testing.assert_array_equal(theta, got["params_by_rank"][0])


def test_multi_seed_dp_sharded_matches_single_device(case):
    """Raw θ is not compared (the JAX spec says why: measurement-flat
    directions random-walk on round-off under Adam); losses and TVDs are."""
    _, out = case
    params, tvd, loss = out["multi_seed"]
    kw = dict(num_seeds=8, ansatz_layers=2, num_epochs=80, base_seed=0)
    _, tvd1, loss1 = train_multi_seed(get_sprinkler_network(), ["C", "S", "R"], {"W": 1}, **kw,
                                      device="cpu")
    np.testing.assert_allclose(loss, loss1, rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(tvd, tvd1, rtol=1e-4, atol=5e-4)
    qbm = QuantumBornMachine(3, ansatz_layers=2, device="cpu")
    params0 = np.stack([qbm.init(torch.Generator().manual_seed(k)).numpy() for k in range(8)])
    _, tvd_j, loss_j = j_train_multi_seed(j_sprinkler(), ["C", "S", "R"], {"W": 1}, **kw,
                                          params0=params0)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(tvd, tvd_j, rtol=1e-4, atol=5e-4)
    assert params.shape == (8, qbm.num_params)


def test_multi_seed_guard_freezes_only_bad_seed(case):
    """A non-finite loss in one replica freezes that replica alone, with the
    seeds split over the ranks."""
    _, out = case
    params, tvds, losses = out["guard"]
    assert np.isnan(losses[:, 0]).all()
    assert np.isnan(params[0]).all()
    assert np.isfinite(losses[:, 1:]).all()
    assert np.isfinite(params[1:]).all()
    assert (losses[-1, 1:] < losses[0, 1:]).all()
