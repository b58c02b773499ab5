"""The port's bn_structured ansatz against the JAX package: ``latent_edges``,
the plain oracle ``make_structured_probs_fn`` (the ``structured2d``
backend), and the circuit kernels' plain versions with one CNOT map per
layer (``circuit2d`` and ``circuit2d_grid``), against JAX's
``make_structured_probs_fn``, ``make_structured_probs_fn_blockcomposed`` and
(for high→low edges, which the block-composed executor refuses)
``make_structured_probs_fn_flat``; the engine and the scale runner with
``bn_structured`` against the JAX engine and runner.

Float64 on the CPU against JAX's complex128 executors: probabilities to
1e-12 and θ-gradients to 1e-10 (summation order; the acceptance bound is
1e-10 on both); engine and runner histories to 1e-9 relative, as
tests/test_torch_engine.py holds them. The CUDA kernels themselves run only
on the card, in chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensornetworks_tpu.core import get_random_chain_network as j_chain
from tensornetworks_tpu.engines.ksd import QuantumKSDVariationalInference as JEngine
from tensornetworks_tpu.models import QuantumBornMachine as JQBM
from tensornetworks_tpu.runners.scale import run_scale_experiment as j_run_scale
from tensornetworks_tpu.sim import structured as jst
from tensornetworks_tpu_torch.core import get_random_chain_network as t_chain
from tensornetworks_tpu_torch.engines import QuantumKSDVariationalInference
from tensornetworks_tpu_torch.interop import quantum_engine_with_params
from tensornetworks_tpu_torch.models import QuantumBornMachine
from tensornetworks_tpu_torch.ops.kernels import _lib
from tensornetworks_tpu_torch.ops.kernels import circuit2d as kc
from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg
from tensornetworks_tpu_torch.runners import scale as tscale
from tensornetworks_tpu_torch.sim import ansatz as tansatz
from tensornetworks_tpu_torch.sim import structured as tst

F64 = torch.float64
BN = "bn_structured"
BACKENDS = ("structured2d", "circuit2d", "circuit2d_grid")


def _edges(n, seed=1):
    """The latent edges of a random chain network of n+1 variables."""
    return jst.latent_edges(j_chain(n + 1, seed=seed), [f"V{i}" for i in range(n)])


def _theta(n, L, seed):
    return np.random.default_rng(seed).uniform(0, 2 * np.pi, 3 * L * n)


def _qbm(n, L, edges, backend):
    return QuantumBornMachine(n, L, BN, backend=backend, dtype=F64, device="cpu", edges=edges)


def _port_probs(n, L, edges, backend, th):
    before = dict(_lib.LAUNCHES)
    q = _qbm(n, L, edges, backend).probs(torch.as_tensor(th)).detach().numpy()
    assert _lib.LAUNCHES == before  # CPU tensors run the plain versions
    return q


@pytest.mark.parametrize("n,seed", [(3, 0), (6, 1), (10, 2), (16, 0), (20, 0), (20, 5)])
def test_latent_edges_match_jax(n, seed):
    latent = [f"V{i}" for i in range(n)]
    want = jst.latent_edges(j_chain(n + 1, seed=seed), latent)
    assert tst.latent_edges(t_chain(n + 1, seed=seed), latent) == want
    assert tst.latent_edges(j_chain(n + 1, seed=seed), latent) == want
    assert all(c < t for c, t in want)  # a chain network lists parents first


# (n, L) from 3 to 13 qubits and 1 to 8 layers, on random chain DAGs.
SIZES = [(3, 1), (3, 2), (4, 8), (5, 3), (6, 5), (7, 4), (8, 2), (9, 7), (10, 6), (11, 8),
         (12, 3), (13, 5)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,L", SIZES)
def test_probs_match_jax_structured(n, L, backend):
    edges = _edges(n)
    th = _theta(n, L, seed=10 * n + L)
    p_j = np.asarray(jst.make_structured_probs_fn(n, L, edges, dtype=jnp.complex128)(
        jnp.asarray(th)))
    np.testing.assert_allclose(_port_probs(n, L, edges, backend, th), p_j, atol=1e-12, rtol=0)


@pytest.mark.parametrize("n,L", [(5, 3), (9, 4), (12, 8)])
def test_probs_match_jax_blockcomposed(n, L):
    """The JAX package's production executor for bn_structured (its GF(2)
    block-composed form, block 4 so that edges cross blocks)."""
    edges = _edges(n, seed=2)
    th = _theta(n, L, seed=n)
    p_j = np.asarray(jst.make_structured_probs_fn_blockcomposed(
        n, L, edges, block=4, dtype=jnp.complex128)(jnp.asarray(th)))
    for backend in BACKENDS:
        np.testing.assert_allclose(_port_probs(n, L, edges, backend, th), p_j, atol=1e-12,
                                   rtol=0, err_msg=backend)


# High→low edges (the JAX package needs its flat executor for them), a pair
# listed twice (two CNOTs cancel; two CZs cancel), and no edges at all.
EDGE_CASES = {
    "high_to_low": (6, 4, [(5, 0), (3, 1), (4, 2), (1, 0), (5, 3)]),
    "repeated": (5, 4, [(0, 3), (0, 3), (1, 2), (4, 1), (1, 2), (2, 4)]),
    "mixed": (7, 5, [(6, 0), (0, 6), (2, 5), (2, 5), (5, 2), (3, 4), (1, 0), (1, 0)]),
    "none": (6, 3, []),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_probs_match_jax_on_edge_lists(case, backend):
    n, L, edges = EDGE_CASES[case]
    th = _theta(n, L, seed=len(edges))
    p_j = np.asarray(jst.make_structured_probs_fn(n, L, edges, dtype=jnp.complex128)(
        jnp.asarray(th)))
    p_flat = np.asarray(jst.make_structured_probs_fn_flat(n, L, edges, dtype=jnp.complex128)(
        jnp.asarray(th)))
    np.testing.assert_allclose(p_flat, p_j, atol=1e-12)
    np.testing.assert_allclose(_port_probs(n, L, edges, backend, th), p_j, atol=1e-12, rtol=0)


GRAD_CASES = [(3, 2, None), (6, 3, None), (8, 4, None), (11, 8, None),
              (6, 4, EDGE_CASES["high_to_low"][2]), (5, 4, EDGE_CASES["repeated"][2])]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,L,edges", GRAD_CASES)
def test_theta_grad_matches_jax_grad(n, L, edges, backend):
    edges = _edges(n) if edges is None else edges
    th = _theta(n, L, seed=n * L)
    v = np.random.default_rng(n).normal(size=2**n)
    fn = jst.make_structured_probs_fn(n, L, edges, dtype=jnp.complex128)
    g_j = np.asarray(jax.grad(lambda p: fn(p) @ jnp.asarray(v))(jnp.asarray(th)))
    p = torch.as_tensor(th).requires_grad_(True)
    (_qbm(n, L, edges, backend).probs(p) @ torch.as_tensor(v)).backward()
    np.testing.assert_allclose(p.grad.numpy(), g_j, atol=1e-10, rtol=0)


def test_grid_plain_path_n18_matches_jax():
    """The grid plan's index-form plain version at the grid's first size,
    on the bench network's DAG: probabilities and θ-gradient."""
    n, L = 18, 2
    edges = _edges(n, seed=0)
    th = 0.3 * np.random.default_rng(18).normal(size=3 * L * n)
    v = np.random.default_rng(19).normal(size=2**n)
    fn = jst.make_structured_probs_fn(n, L, edges, dtype=jnp.complex128)
    p_j = np.asarray(fn(jnp.asarray(th)))
    g_j = np.asarray(jax.grad(lambda p: fn(p) @ jnp.asarray(v))(jnp.asarray(th)))
    qbm = QuantumBornMachine(n, L, BN, dtype=F64, device="cpu", edges=edges)
    assert qbm.backend == "circuit2d_grid"
    p = torch.as_tensor(th).requires_grad_(True)
    q = qbm.probs(p)
    (q @ torch.as_tensor(v)).backward()
    np.testing.assert_allclose(q.detach().numpy(), p_j, atol=1e-12, rtol=0)
    np.testing.assert_allclose(p.grad.numpy(), g_j, atol=1e-10, rtol=0)


def test_cz_masks_cancel_a_repeated_pair():
    """Two CZs on one pair are the identity, as the JAX ``odd_layer_sign``
    has it (it multiplies the signs): the masks XOR, so the pair listed
    twice leaves no sign, and three times leaves one."""
    n = 4
    assert not kc.cz_masks(n, [(0, 2), (0, 2)]).any()
    np.testing.assert_array_equal(kc.cz_masks(n, [(0, 2), (1, 3), (0, 2)]),
                                  kc.cz_masks(n, [(1, 3)]))
    np.testing.assert_array_equal(kc.cz_masks(n, [(0, 2)] * 3), kc.cz_masks(n, [(0, 2)]))
    _, sign = kc.expand_maps(kc.gf2_rows(n, []), kc.cz_masks(n, [(0, 2), (0, 2)])[None], "cpu")
    assert bool((sign == 1.0).all())


def test_plans_hold_one_map_per_layer():
    """Both plans: layer l's rows and CZ masks by parity, (L, n) each;
    CircuitPlan's (2L, n) device table interleaved; GridPlan folds nothing;
    the fixed ansätze keep one shared dst and, on the grid, one map."""
    n, L, edges = 7, 5, [(0, 3), (3, 6), (6, 1)]
    plan = kc.CircuitPlan(n, L, BN, edges)
    even_rows, odd_rows = kc.gf2_rows(n, edges), kc.gf2_rows(n, [])
    for layer in range(L):
        even = layer % 2 == 0
        np.testing.assert_array_equal(plan.rows[layer], even_rows if even else odd_rows)
        np.testing.assert_array_equal(plan.cz[layer], kc.cz_masks(n, [] if even else edges))
    masks = plan.device_masks("cpu").numpy().view(np.uint32)
    assert masks.shape == (2 * L, n)
    np.testing.assert_array_equal(masks[0::2], plan.rows)
    np.testing.assert_array_equal(masks[1::2], plan.cz)
    dst, sign = plan.tables("cpu")
    assert tuple(dst.shape) == (L, 2**n) and tuple(sign.shape) == (L, 2**n)
    assert sorted(dst[1].tolist()) == list(range(2**n))
    assert dst[1].tolist() == list(range(2**n))  # odd layers: identity map
    grid = kg.GridPlan(n, L, BN, edges)
    assert grid.row_src is None and grid.index_form and grid.has_wall
    np.testing.assert_array_equal(grid.rows, plan.rows)
    np.testing.assert_array_equal(grid.cz, plan.cz)
    gdst, gsign = grid.tables("cpu")
    assert torch.equal(gdst, dst) and torch.equal(gsign, sign)
    he = kc.CircuitPlan(n, L, "hardware_efficient")
    assert he.tables("cpu")[0].dim() == 1 and he.rows.shape == (L, n)
    he_grid = kg.GridPlan(n, L, "hardware_efficient")
    assert he_grid.rows.shape == he_grid.cz.shape == (L, n)
    assert (he_grid.rows == he_grid.rows[0]).all()
    np.testing.assert_array_equal(he_grid.cz, he.cz)


@pytest.mark.parametrize("grid,n", [(False, 5), (False, 16), (True, 18), (True, 20)])
def test_scatter_split_holds_for_dag_maps(grid, n):
    """The large loop's epilogue split d = dst(m·N) ⊕ dst(n) and its CZ
    sign, for the bn_structured maps of both parities."""
    edges = _edges(n, seed=0) + [(n - 1, 0), (n - 1, 0), (n - 2, 1)]
    plan = (kg.GridPlan if grid else kc.CircuitPlan)(n, 2, BN, edges)
    rng = np.random.default_rng(n)
    idx = np.concatenate([[0, (1 << n) - 1], rng.integers(0, 1 << n, 4094)])
    for layer in range(2):
        rows, cz = plan.rows[layer], plan.cz[layer]
        dst, sign = kc.expand_maps(rows, cz[None], "cpu", index=idx)
        d, s = kc.scatter_targets(rows, cz, idx // plan.C, idx % plan.C, plan.C)
        np.testing.assert_array_equal(d, dst.numpy())
        np.testing.assert_array_equal(s, sign[0].numpy())


def test_model_and_plans_validate():
    assert tansatz.num_ansatz_params(5, 3, BN) == 45 and BN in tansatz.ANSATZ_TYPES
    with pytest.raises(ValueError, match="requires edges"):
        QuantumBornMachine(4, 2, BN, device="cpu")
    for backend in ("blocked2d", "einsum"):
        with pytest.raises(ValueError, match="structured2d"):
            QuantumBornMachine(4, 2, BN, backend=backend, device="cpu", edges=[(0, 1)])
    with pytest.raises(ValueError, match="bn_structured ansatz only"):
        QuantumBornMachine(4, 2, backend="structured2d", device="cpu")
    with pytest.raises(ValueError, match="structured2d"):
        QuantumBornMachine(kg.GATE_MAX_QUBITS + 1, 1, BN, device="cpu", edges=[])
    with pytest.raises(ValueError, match="structured2d"):
        QuantumBornMachine(kg.MAX_QUBITS + 1, 1, BN, dtype=torch.float64, device="cpu",
                           edges=[])
    for bad in ([(1, 1)], [(0, 4)], [(-1, 2)]):
        with pytest.raises(ValueError, match="bad edge"):
            QuantumBornMachine(4, 2, BN, device="cpu", edges=bad)
        with pytest.raises(ValueError, match="bad edge"):
            tst.make_structured_probs_fn(4, 2, bad)
    with pytest.raises(ValueError, match="needs edges"):
        kc.CircuitPlan(4, 2, BN)
    with pytest.raises(ValueError, match="needs edges"):
        kg.GridPlan(4, 2, BN)
    with pytest.raises(ValueError):
        tansatz.ansatz_state(torch.zeros(24), 4, 2, BN)
    for n, backend in ((2, "circuit2d"), (17, "circuit2d"), (18, "circuit2d_grid"),
                       (kg.MAX_QUBITS, "circuit2d_grid"), (kg.GATE_MAX_QUBITS, "circuit2d_grid")):
        qbm = QuantumBornMachine(n, 1, BN, device="cpu", edges=[(0, 1)])
        assert qbm.backend == backend and qbm.edges == [(0, 1)]


def test_engine_history_matches_jax():
    """20 epochs from a shared θ at n=13 (the Kronecker Stein path), with
    the edges derived from the network on both sides."""
    n, L, epochs = 13, 3, 20
    latent, obs = [f"V{i}" for i in range(n)], {f"V{n}": 1}
    theta = 0.1 * np.random.default_rng(n).normal(size=3 * L * n)
    jbn = j_chain(n + 1, seed=0)
    jeng = JEngine(jbn, latent, list(obs), qbm_num_latent_vars=n, qbm_ansatz_layers=L,
                   qbm_ansatz_type=BN, dtype=jnp.float64, base_kernel_length_scale=0.1)
    jeng.born_machine = JQBM(n, ansatz_layers=L, ansatz_type=BN, dtype=jnp.complex128,
                             edges=jeng.born_machine.edges, backend="structured2d")
    jeng.params = jnp.asarray(theta)
    teng = quantum_engine_with_params(theta, t_chain(n + 1, seed=0), latent, list(obs),
                                      qbm_ansatz_layers=L, qbm_ansatz_type=BN, dtype=F64,
                                      device="cpu", base_kernel_length_scale=0.1)
    assert teng.born_machine.backend == "circuit2d"
    assert teng.born_machine.edges == jeng.born_machine.edges
    post = t_chain(n + 1, seed=0).posterior_vector(latent, obs)
    kw = dict(num_epochs=epochs, lr_born_machine=0.05, verbose=False,
              true_posterior_for_tvd=post)
    hj = jeng.train(obs, **kw)
    ht = teng.train(obs, chunk_epochs=7, **kw)
    for key in ("loss_ksd", "tvd", "grad_norm"):
        np.testing.assert_allclose(ht[key], hj[key], rtol=1e-9, err_msg=key)
    assert teng.best_tvd_ == pytest.approx(jeng.best_tvd_, rel=1e-9)
    assert teng.best_epoch_ == jeng.best_epoch_
    assert ht["loss_ksd"][-1] < ht["loss_ksd"][0]


def test_engine_takes_explicit_edges():
    n = 4
    bn = t_chain(n + 1, seed=0)
    latent = [f"V{i}" for i in range(n)]
    eng = QuantumKSDVariationalInference(bn, latent, [f"V{n}"], qbm_num_latent_vars=n,
                                         qbm_ansatz_type=BN, qbm_edges=[(3, 0)],
                                         device="cpu")
    assert eng.born_machine.edges == [(3, 0)]


@pytest.mark.parametrize("n,phases", [(5, None), (8, [(6, 0.05), (4, 0.01, 0.5)])])
def test_run_scale_experiment_matches_jax_runner(n, phases, monkeypatch):
    """The runner's bn_structured branch from the JAX runner's θ (its seeded
    init, handed to the port's Born machine), float32 on both sides as the
    runners run: the histories agree to 2e-4 relative (float32 round-off of
    2^n-long sums, carried through the epochs)."""
    L, epochs = 2, 8
    out_j = j_run_scale(num_qubits=n, layers=L, num_epochs=epochs, lr=0.05, seed=1,
                        ansatz=BN, lr_phases=phases, verbose=False, backend="structured2d")
    theta = np.asarray(JQBM(n, ansatz_layers=L, ansatz_type=BN, edges=[(0, 1)]).init(
        jax.random.PRNGKey(1)))
    monkeypatch.setattr(QuantumBornMachine, "init", lambda self, generator: torch.as_tensor(
        theta, dtype=self.dtype, device=self.device))
    out_t = tscale.run_scale_experiment(num_qubits=n, layers=L, num_epochs=epochs, lr=0.05,
                                        seed=1, ansatz=BN, lr_phases=phases, verbose=False,
                                        device="cpu")
    mt, mj = out_t["model"], out_j["model"]
    assert mt.born_machine.backend == "circuit2d"
    assert mt.born_machine.edges == mj.born_machine.edges
    for key in ("loss_ksd", "tvd"):
        np.testing.assert_allclose(out_t["history"][key], out_j["history"][key], rtol=2e-4,
                                   err_msg=key)
    assert mt.best_tvd_ == pytest.approx(mj.best_tvd_, rel=2e-4)
