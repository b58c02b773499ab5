"""The port's conditioned quantum Born machine against the JAX package: the
RY(angles) conditioning wall folded into the circuit kernels' operator
planes (one wall into layer 0, or re-uploaded before every layer), the
grid kernels' fold before the row-chain gather, the blocked executor's and
the structured oracle's wall, the learned embedding W·φ(x) with per-layer
scales, and each validation error.

Float64 on the CPU (complex128 on the JAX side), where the kernels'
wrappers run their plain versions: probabilities and gradients to 1e-10.
Against the JAX package's float32 Pallas kernels in interpret mode, 5e-6
on probabilities and 5e-5 on gradients (float32 round-off, as in
tests/test_torch_circuit_grid.py). The JAX model reads x as float32, so
the model-level cases pass it float64 through a ``jnp`` whose float32 is
float64 (patched in its module only). The CUDA kernels themselves run only
on the card, in chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensornetworks_tpu.core import get_random_chain_network as j_chain
from tensornetworks_tpu.models import QuantumBornMachine as JQBM
from tensornetworks_tpu.models import born_quantum as jborn
from tensornetworks_tpu.ops.pallas.circuit2d import make_pallas_circuit2d_probs
from tensornetworks_tpu.ops.pallas.circuit2d_grid import make_pallas_circuit2d_grid_probs
from tensornetworks_tpu.sim import latent_edges as j_latent_edges
from tensornetworks_tpu.sim.blocked import make_blocked_probs_fn as j_blocked
from tensornetworks_tpu.sim.structured import (make_structured_probs_fn as j_structured,
                                               make_structured_probs_fn_blockcomposed,
                                               make_structured_probs_fn_flat)
from tensornetworks_tpu_torch.models import QuantumBornMachine
from tensornetworks_tpu_torch.ops.kernels import _lib
from tensornetworks_tpu_torch.ops.kernels import circuit2d as kc
from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg
from tensornetworks_tpu_torch.sim.ansatz import num_ansatz_params
from tensornetworks_tpu_torch.sim.blocked import make_blocked_probs_fn
from tensornetworks_tpu_torch.sim.gates import rotation_operators, wall_operators
from tensornetworks_tpu_torch.sim.structured import make_structured_probs_fn

F64 = torch.float64
BN = "bn_structured"
MAKERS = {"circuit2d": kc.make_circuit2d_probs_fn,
          "circuit2d_grid": kg.make_circuit2d_grid_probs_fn}
JAX_STRUCTURED = {"flat": make_structured_probs_fn_flat,
                  "blockcomposed": make_structured_probs_fn_blockcomposed}


class F64Jnp:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _rng(seed):
    return np.random.default_rng(seed)


def _edges(n):
    bn = j_chain(n + 2, seed=0)
    return j_latent_edges(bn, [f"V{i}" for i in range(n)])


def _torch_probs_and_grads(fn, theta, angles, v):
    """probs, d(probs·v)/dθ and d(probs·v)/d(angles) of a port builder."""
    p = torch.as_tensor(theta).requires_grad_(True)
    a = torch.as_tensor(angles).requires_grad_(True)
    q = fn(p, a)
    gp, ga = torch.autograd.grad(q @ torch.as_tensor(v), (p, a))
    return q.detach().numpy(), gp.numpy(), ga.numpy()


def _jax_probs_and_grads(fn, theta, angles, v):
    th, an, vv = jnp.asarray(theta), jnp.asarray(angles), jnp.asarray(v)
    gp, ga = jax.grad(lambda p, a: fn(p, a) @ vv, argnums=(0, 1))(th, an)
    return np.asarray(fn(th, an)), np.asarray(gp), np.asarray(ga)


def _assert_close(got, want, atol):
    for name, g, w in zip(("probs", "theta-grad", "angle-grad"), got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("backend", list(MAKERS))
@pytest.mark.parametrize("ansatz", ["hardware_efficient", "basic", "all_to_all"])
@pytest.mark.parametrize("n", [3, 6])
def test_fixed_wall_matches_jax_blocked(backend, ansatz, n):
    """One wall after the Hadamard wall, folded into layer 0's operators,
    against the JAX blocked executor's wall on the state."""
    L = 3
    rng = _rng(n)
    theta = rng.uniform(0, 2 * np.pi, num_ansatz_params(n, L, ansatz))
    angles, v = rng.uniform(0, 2 * np.pi, n), rng.normal(size=2**n)
    before = dict(_lib.LAUNCHES)
    got = _torch_probs_and_grads(MAKERS[backend](n, L, ansatz, conditioning=True),
                                 theta, angles, v)
    assert _lib.LAUNCHES == before  # CPU tensors never reach a kernel
    want = _jax_probs_and_grads(j_blocked(n, L, ansatz, dtype=jnp.complex128,
                                          conditioning=True), theta, angles, v)
    _assert_close(got, want, 1e-10)


@pytest.mark.parametrize("ansatz", ["hardware_efficient", "basic"])
def test_blocked_wall_matches_jax_blocked(ansatz):
    """The port's blocked executor with the wall (blocks of 2 and a
    remainder block), the oracle of conditioned machines past 24 qubits."""
    n, L = 5, 2
    rng = _rng(11)
    theta = rng.uniform(0, 2 * np.pi, num_ansatz_params(n, L, ansatz))
    angles, v = rng.uniform(0, 2 * np.pi, n), rng.normal(size=2**n)
    got = _torch_probs_and_grads(make_blocked_probs_fn(n, L, ansatz, block=2,
                                                       dtype=torch.complex128,
                                                       conditioning=True), theta, angles, v)
    want = _jax_probs_and_grads(j_blocked(n, L, ansatz, dtype=jnp.complex128,
                                          conditioning=True), theta, angles, v)
    _assert_close(got, want, 1e-10)


@pytest.mark.parametrize("backend", list(MAKERS))
def test_fixed_wall_matches_pallas_in_interpret_mode(backend):
    """The same fold against the JAX package's Pallas builders with
    ``conditioning=True``, which fold the wall outside the kernel."""
    n, L, ansatz = 5, 2, "hardware_efficient"
    rng = _rng(5)
    theta = rng.uniform(0, 2 * np.pi, num_ansatz_params(n, L, ansatz))
    angles, v = rng.uniform(0, np.pi, n), rng.normal(size=2**n)
    jmake = (make_pallas_circuit2d_grid_probs if backend == "circuit2d_grid"
             else make_pallas_circuit2d_probs)
    fj = jmake(n, L, ansatz, interpret=True, conditioning=True)
    th32, an32 = jnp.asarray(theta, jnp.float32), jnp.asarray(angles, jnp.float32)
    q_j = np.asarray(fj(th32, an32))
    g_j = np.asarray(jax.grad(lambda p: fj(p, an32) @ jnp.asarray(v, jnp.float32))(th32))
    q_t, g_t, _ = _torch_probs_and_grads(MAKERS[backend](n, L, ansatz, conditioning=True),
                                         theta, angles, v)
    np.testing.assert_allclose(q_t, q_j, atol=5e-6, rtol=0)
    np.testing.assert_allclose(g_t, g_j, atol=5e-5, rtol=0)


def test_grid_folds_the_wall_before_the_row_gather():
    """At n=6 the hardware_efficient grid plan has a row chain, so the
    streamed operator is P_row·(Mr[0]·Er): the wall before the rotations,
    the row chain after them. Matrix products associate, so gathering the
    rows of Mr[0] first and multiplying by Er after gives the same planes;
    what must not happen is the wall acting after the row chain (Er·P_row·
    Mr[0]) or the gather reaching the wall too ((P_row·Mr[0])·(P_row·Er)).
    The port matches JAX, and both misplacements are far from it."""
    n, L, ansatz = 6, 2, "hardware_efficient"
    plan = kg.GridPlan(n, L, ansatz)
    idx = plan.row_index("cpu")
    assert idx is not None
    rng = _rng(6)
    theta = torch.as_tensor(rng.uniform(0, 2 * np.pi, num_ansatz_params(n, L, ansatz)))
    angles = torch.as_tensor(rng.uniform(0, 2 * np.pi, n))
    want = np.asarray(j_blocked(n, L, ansatz, dtype=jnp.complex128, conditioning=True)(
        jnp.asarray(theta.numpy()), jnp.asarray(angles.numpy())))
    planes = kg.grid_operators(theta, plan, angles)
    got = kg.circuit2d_grid_forward_plain(*planes, plan)[0].reshape(-1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)

    Mr, Mc = rotation_operators(theta, n, L, plan.per_qubit)
    Er, Ec = wall_operators(angles, n)
    Mc = torch.cat([(Mc[0] @ Ec)[None], Mc[1:]])
    streamed = Mr[:, idx]
    for wrong0 in (Er @ streamed[0], streamed[0] @ Er[idx]):
        mr = torch.cat([wrong0[None], streamed[1:]])
        wrong = kg.circuit2d_grid_forward_plain(mr.real.contiguous(), mr.imag.contiguous(),
                                                Mc.real.contiguous(), Mc.imag.contiguous(),
                                                plan)[0].reshape(-1)
        assert np.abs(wrong.numpy() - want).max() > 1e-3


@pytest.mark.parametrize("per_layer", [False, True], ids=["shared-wall", "per-layer-walls"])
@pytest.mark.parametrize("jax_executor", list(JAX_STRUCTURED))
@pytest.mark.parametrize("backend", list(MAKERS))
def test_bn_reupload_matches_jax_structured(backend, jax_executor, per_layer):
    """bn_structured with the wall before every layer's rotations
    (``Mr[l]·Er_l``) against the JAX flat and block-composed structured
    executors with ``reupload=True``."""
    n, L = 7, 4
    edges = _edges(n)
    rng = _rng(7)
    theta = rng.uniform(0, 2 * np.pi, 3 * L * n)
    angles = rng.uniform(0, 2 * np.pi, (L, n) if per_layer else n)
    v = rng.normal(size=2**n)
    got = _torch_probs_and_grads(MAKERS[backend](n, L, BN, edges, conditioning=True,
                                                 reupload=True), theta, angles, v)
    want = _jax_probs_and_grads(JAX_STRUCTURED[jax_executor](
        n, L, edges, block=3, dtype=jnp.complex128, conditioning=True, reupload=True),
        theta, angles, v)
    _assert_close(got, want, 1e-10)


@pytest.mark.parametrize("backend", list(MAKERS) + ["oracle"])
def test_bn_single_wall_matches_jax_oracle(backend):
    """bn_structured with one wall: the kernels' fold and the port's own
    oracle (its wall applied qubit by qubit) against JAX's 2D oracle."""
    n, L = 6, 3
    edges = _edges(n)
    rng = _rng(8)
    theta = rng.uniform(0, 2 * np.pi, 3 * L * n)
    angles, v = rng.uniform(0, 2 * np.pi, n), rng.normal(size=2**n)
    fn = (make_structured_probs_fn(n, L, edges, conditioning=True) if backend == "oracle"
          else MAKERS[backend](n, L, BN, edges, conditioning=True))
    got = _torch_probs_and_grads(fn, theta, angles, v)
    want = _jax_probs_and_grads(j_structured(n, L, edges, dtype=jnp.complex128,
                                             conditioning=True), theta, angles, v)
    _assert_close(got, want, 1e-10)


def test_per_layer_angles_need_reupload():
    fn = kc.make_circuit2d_probs_fn(4, 2, BN, _edges(4), conditioning=True)
    with pytest.raises(ValueError, match="reupload"):
        fn(torch.zeros(24, dtype=F64), torch.zeros((2, 4), dtype=F64))
    with pytest.raises(ValueError, match="embed_angles"):
        fn(torch.zeros(24, dtype=F64))


MODEL_CASES = {
    "he-fixed": dict(n=5, L=2, d=2, ansatz="hardware_efficient"),
    "he-fixed-d3-grid": dict(n=6, L=2, d=3, ansatz="hardware_efficient",
                             backend="circuit2d_grid"),
    "bn-reupload": dict(n=6, L=3, d=2, ansatz=BN, cond_reupload=True),
    "bn-learned": dict(n=6, L=3, d=2, ansatz=BN, cond_reupload=True,
                       cond_learned_embedding=True),
    "bn-learned-per-layer": dict(n=6, L=4, d=2, ansatz=BN, cond_reupload=True,
                                 cond_learned_embedding=True, cond_embed_per_layer=True),
    "bn-learned-per-layer-grid": dict(n=7, L=2, d=1, ansatz=BN, cond_reupload=True,
                                      cond_learned_embedding=True, cond_embed_per_layer=True,
                                      backend="circuit2d_grid"),
}


def _models(case):
    cfg = dict(MODEL_CASES[case])
    n, L, d, ansatz = cfg.pop("n"), cfg.pop("L"), cfg.pop("d"), cfg.pop("ansatz")
    backend = cfg.pop("backend", "auto")
    edges = _edges(n) if ansatz == BN else None
    jm = JQBM(n, ansatz_layers=L, conditioning_dim=d, ansatz_type=ansatz, edges=edges,
              dtype=jnp.complex128, **cfg)
    tm = QuantumBornMachine(n, L, ansatz, backend=backend, dtype=F64, device="cpu",
                            edges=edges, conditioning_dim=d, **cfg)
    return jm, tm, n, d


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_matches_jax(case, monkeypatch):
    """The whole model: θ ⊕ W ⊕ s in the JAX layout, x → angles
    (π·tile(x), W·φ(x) or s ⊙ W·φ(x)), probs and the gradient in every
    parameter, W and s included, for several observations."""
    monkeypatch.setattr(jborn, "jnp", F64Jnp())
    jm, tm, n, d = _models(case)
    assert tm.backend in MAKERS
    assert (tm.num_params, tm.num_circuit_params) == (jm.num_params, jm.num_circuit_params)
    rng = _rng(len(case))
    params = rng.uniform(0, 2 * np.pi, tm.num_params)
    v = rng.normal(size=2**n)
    for x in ([1.0] * d, [0.0] * d, [float(b) for b in rng.integers(0, 2, d)]):
        xj = jnp.asarray(x, dtype=jnp.float64)
        np.testing.assert_allclose(
            np.asarray(tm._embed_angles(torch.as_tensor(x, dtype=F64),
                                        torch.as_tensor(params)).numpy()),
            np.asarray(jm._embed_angles(xj, jnp.asarray(params))), atol=1e-12, rtol=0)
        p = torch.as_tensor(params).requires_grad_(True)
        q = tm.probs(p, torch.as_tensor(x, dtype=F64))
        (g,) = torch.autograd.grad(q @ torch.as_tensor(v), p)
        pj = jnp.asarray(params)
        np.testing.assert_allclose(q.detach().numpy(), np.asarray(jm.probs(pj, xj)),
                                   atol=1e-10, rtol=0)
        g_j = np.asarray(jax.grad(lambda pp: jm.probs(pp, xj) @ jnp.asarray(v))(pj))
        np.testing.assert_allclose(g.numpy(), g_j, atol=1e-10, rtol=0)
        if tm.num_params > tm.num_circuit_params:
            assert np.abs(g.numpy()[tm.num_circuit_params:]).max() > 0  # W and s get gradient


@pytest.mark.parametrize("d", [1, 2, 3])
def test_interaction_features_match_jax(d):
    jm = JQBM(4, conditioning_dim=d, cond_learned_embedding=True)
    tm = QuantumBornMachine(4, conditioning_dim=d, cond_learned_embedding=True, dtype=F64,
                            device="cpu")
    x = _rng(d).normal(size=d)
    np.testing.assert_allclose(tm._interaction_features(torch.as_tensor(x)).numpy(),
                               np.asarray(jm._interaction_features(jnp.asarray(x))),
                               atol=1e-14, rtol=0)


def test_learned_init_is_the_fixed_wall_and_scales_gate():
    """Mirrors the JAX package's test: the learned embedding starts as the
    fixed wall (W[q, 1 << (q mod d)] = π), the per-layer scales start at 1
    (as the shared learned wall), add exactly L·n parameters and get
    gradient; the flag needs the learned embedding and re-uploading."""
    n, L, d = 6, 4, 2
    edges = _edges(n)
    kw = dict(dtype=F64, device="cpu", edges=edges, conditioning_dim=d, cond_reupload=True)
    fixed = QuantumBornMachine(n, L, BN, **kw)
    base = QuantumBornMachine(n, L, BN, cond_learned_embedding=True, **kw)
    per = QuantumBornMachine(n, L, BN, cond_learned_embedding=True, cond_embed_per_layer=True,
                             **kw)
    assert base.num_params == fixed.num_params + n * 2**d
    assert per.num_params == base.num_params + L * n
    pf, pb, pp = (m.init(torch.Generator().manual_seed(3)) for m in (fixed, base, per))
    assert torch.equal(pb[:fixed.num_params], pf) and torch.equal(pp[:base.num_params], pb)
    W = pb[fixed.num_params:].reshape(n, 2**d)
    assert torch.equal(W[torch.arange(n), 1 << (torch.arange(n) % d)], torch.full((n,), np.pi,
                                                                                dtype=F64))
    assert int((W != 0).sum()) == n and torch.equal(pp[base.num_params:], torch.ones(L * n,
                                                                                 dtype=F64))
    for x in ([0.0, 1.0], [1.0, 1.0]):
        xt = torch.tensor(x, dtype=F64)
        q = fixed.probs(pf, xt)
        np.testing.assert_allclose(base.probs(pb, xt).numpy(), q.numpy(), atol=1e-12)
        np.testing.assert_allclose(per.probs(pp, xt).numpy(), q.numpy(), atol=1e-12)
    v = torch.as_tensor(_rng(0).normal(size=2**n))
    p = pp.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(per.probs(p, torch.tensor([1.0, 0.0], dtype=F64)) @ v, p)
    assert g[base.num_params:].abs().max() > 0


def test_x_condition_on_every_entry_point():
    n = 4
    m = QuantumBornMachine(n, 2, dtype=F64, device="cpu", conditioning_dim=1)
    theta = m.init(torch.Generator().manual_seed(0))
    q0, q1 = m.probs(theta, [0.0]), m.probs(theta, [1.0])
    assert (q0 - q1).abs().max() > 1e-3
    torch.testing.assert_close(m.log_probs(theta, [1.0]), torch.log(q1.clamp(min=1e-9)))
    z = torch.tensor([[0.0, 1.0, 1.0, 0.0], [1.0, 1.0, 1.0, 1.0]])
    torch.testing.assert_close(m.log_q(theta, z, [1.0]),
                               torch.log(q1.clamp(min=1e-9))[torch.tensor([6, 15])])
    s = m.sample(torch.Generator().manual_seed(1), theta, 7, [1.0])
    assert s.shape == (7, n)
    d = m.get_prob_dict(theta, [1.0])
    assert d[(0, 1, 1, 0)] == pytest.approx(float(q1[6]))
    with pytest.raises(ValueError, match="x_condition must be provided"):
        m.probs(theta)
    with pytest.raises(ValueError, match="conditioning_dim is 0"):
        QuantumBornMachine(n, 2, dtype=F64, device="cpu").probs(theta, [1.0])


@pytest.mark.parametrize("n,ansatz,backend", [
    (2, "hardware_efficient", "circuit2d"), (17, BN, "circuit2d"),
    (18, "hardware_efficient", "circuit2d_grid"), (24, BN, "circuit2d_grid"),
    (25, "hardware_efficient", "circuit2d_grid"), (28, BN, "circuit2d_grid"),
    (31, "hardware_efficient", "blocked"), (1, "hardware_efficient", "blocked")])
def test_auto_backend_of_a_conditioned_machine(n, ansatz, backend):
    edges = [(i, i + 1) for i in range(n - 1)] if ansatz == BN else None
    m = QuantumBornMachine(n, 1, ansatz, device="cpu", edges=edges, conditioning_dim=1)
    assert m.backend == backend


ERRORS = {
    "reupload-unconditioned": (dict(ansatz_type=BN, cond_reupload=True), "cond_reupload"),
    "reupload-he": (dict(conditioning_dim=1, cond_reupload=True), "cond_reupload"),
    "learned-unconditioned": (dict(cond_learned_embedding=True), "cond_learned_embedding"),
    "learned-d11": (dict(conditioning_dim=11, cond_learned_embedding=True), "too large"),
    "per-layer-without-learned": (dict(ansatz_type=BN, conditioning_dim=2, cond_reupload=True,
                                       cond_embed_per_layer=True), "cond_embed_per_layer"),
    "per-layer-without-reupload": (dict(conditioning_dim=2, cond_learned_embedding=True,
                                        cond_embed_per_layer=True), "cond_embed_per_layer"),
    "adjoint": (dict(conditioning_dim=1, grad_method="adjoint"), "adjoint"),
    "einsum": (dict(conditioning_dim=1, backend="einsum"), "conditioned"),
    "blocked2d": (dict(conditioning_dim=1, backend="blocked2d"), "conditioned"),
    "structured2d-reupload": (dict(ansatz_type=BN, conditioning_dim=1, cond_reupload=True,
                                   backend="structured2d"), "cond_reupload"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_validation_errors(case):
    kw, match = ERRORS[case]
    kw = dict(kw)
    if kw.get("ansatz_type") == BN:
        kw["edges"] = [(0, 1), (1, 2)]
    with pytest.raises(ValueError, match=match):
        QuantumBornMachine(4, 2, device="cpu", **kw)
