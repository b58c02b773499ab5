"""The grid circuit's gate path (kernel precision ``highest``;
``ops/kernels/circuit2d_grid.py``: the pass plan, the plain versions of
``csrc/circuit_gates.cu`` and ``CircuitGatesFunction``) on the CPU.

- The plan: every qubit gated once a layer, tiles that partition the
  index, each map pass's stores equal to the layer's index map (expanded
  independently by ``circuit2d.expand_maps``) of its loads, and the pass
  counts at the benchmark's 24 qubits.
- The plain forward and backward against the port's oracles, which share
  no code with this path: ``sim.structured.make_structured_probs_fn`` for
  ``bn_structured`` and ``sim.ansatz.ansatz_probs`` for the fixed ansätze,
  probabilities and dθ by autograd through them, in float64 (1e-12, 1e-10:
  summation order) and float32 (relative 2e-6 and 2e-5 of the largest
  magnitude: a few roundings of 2^-24 per gate).
- dθ against the dense plain path (``circuit2d_grid_backward_plain`` pulled
  through ``kron_fold``) without a wall, with one, re-uploaded, and through
  ``probs.batch``.
- The dispatch: ``highest`` takes the gate path, ``high`` and ``default``
  the operator planes; each path's range (the gate path to 30 qubits, the
  operator path to 24, neither building a dense plane past 24) and the
  ``auto`` backend's choice between the gate path and the blocked executor
  by width, kernel precision, dtype and conditioning.

The CUDA kernels themselves run only on the card
(``tests/test_torch_circuit_gates_chip.py``)."""

import numpy as np
import pytest
import torch

from tensornetworks_tpu_torch.models import QuantumBornMachine
from tensornetworks_tpu_torch.models.born_quantum import auto_backend
from tensornetworks_tpu_torch.ops.kernels import _lib
from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg
from tensornetworks_tpu_torch.ops.kernels import precision as kp
from tensornetworks_tpu_torch.ops.kernels.circuit2d import expand_maps, layer_masks, make_probs_fn
from tensornetworks_tpu_torch.sim.ansatz import ansatz_probs, num_ansatz_params
from tensornetworks_tpu_torch.sim.structured import make_structured_probs_fn

F64, F32 = torch.float64, torch.float32
HE, BN = "hardware_efficient", "bn_structured"
ANSATZE = (HE, "basic", "all_to_all", BN)


def _edges(n, seed=5):
    """A random DAG over n qubits, parents before children (the benchmark's
    networks), and one child-before-parent edge where n > 2."""
    rng = np.random.default_rng(seed)
    edges = [(int(p), c) for c in range(1, n)
             for p in rng.choice(c, size=min(c, int(rng.integers(0, 3))), replace=False)]
    return edges + ([(n - 1, 1)] if n > 2 else [])


def _theta(n, L, ansatz, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0, 2 * np.pi, num_ansatz_params(n, L, ansatz)))


@pytest.fixture
def kernel_precision():
    """Sets the kernel precision for plans built in the test; restores it."""
    old = kp._kernel_precision()
    yield kp.set_kernel_precision
    kp.set_kernel_precision(old)


@pytest.mark.parametrize("n,ansatz", [(n, a) for n in (2, 3, 5, 8, 13) for a in ANSATZE]
                         + [(18, HE), (18, BN)])
def test_plan_partitions_the_state_and_applies_the_maps(n, ansatz):
    L = 2
    edges = _edges(n) if ansatz == BN else None
    plan = kg.GridPlan(n, L, ansatz, edges)
    rows, cz = layer_masks(n, L, ansatz, edges)
    passes = plan.gate_passes()
    everything = torch.arange(1 << n)
    for layer in range(L):
        mine = [ps for ps in passes if ps.layer == layer]
        assert sorted(q for ps in mine for _, q in ps.gates) == list(range(n))
        assert all(ps.rows is None and ps.cz is None for ps in mine[:-1])
        dst_map, sign = expand_maps(rows[layer], cz[layer][None], "cpu")
        for ps in mine:
            assert ps.k <= kg.GATE_TILE_BITS and ps.m >= 2
            assert ps.lin[:ps.m] == [1 << t for t in range(ps.m)]
            assert all(ps.lin[t] == 1 << (n - 1 - q) for t, q in ps.gates)
            src, dst, pos = kg.gate_pass_index(ps, "cpu")
            assert torch.equal(src.reshape(-1).sort().values, everything)
            assert torch.equal(dst.reshape(-1).sort().values, everything)
            moved = src.gather(1, pos)
            if ps is mine[-1]:
                assert torch.equal(dst, dst_map[moved])
                assert torch.equal(kg.cz_sign(dst, cz[layer]).double(), sign[0][moved])
            else:
                assert torch.equal(dst, moved)


@pytest.mark.parametrize("ansatz,L,most", [(HE, 4, 3), (BN, 8, 3)])
def test_passes_at_24_qubits(ansatz, L, most):
    """At most three passes a layer at the benchmark's width, 16-byte runs
    or longer (m >= 2), every tile within 4096 amplitudes."""
    plan = kg.GridPlan(24, L, ansatz, _edges(24, seed=11)[:-1] if ansatz == BN else None)
    passes = plan.gate_passes()
    assert len(passes) <= most * L
    assert all(ps.m >= 2 and ps.k <= kg.GATE_TILE_BITS for ps in passes)
    assert plan.gate_records().shape == (len(passes), kg.GATE_SPEC_WORDS)
    assert plan.gate_partials() == sum(len(ps.gates) << (24 - ps.k) for ps in passes)


def _oracle(n, L, ansatz, edges):
    if ansatz == BN:
        return make_structured_probs_fn(n, L, edges)
    return lambda p: ansatz_probs(p, n, L, ansatz)


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("n,ansatz,L", [(2, HE, 2), (3, "basic", 2), (4, "all_to_all", 2),
                                        (5, BN, 3), (7, HE, 3), (8, BN, 2), (10, "basic", 2),
                                        (10, BN, 2), (13, HE, 2), (13, BN, 2)])
def test_gate_path_matches_the_oracles(n, ansatz, L, dtype):
    edges = _edges(n) if ansatz == BN else None
    th = _theta(n, L, ansatz, seed=n + L).to(dtype)
    v = torch.as_tensor(np.random.default_rng(n).normal(size=2**n), dtype=dtype)
    p = th.clone().requires_grad_(True)
    before = dict(_lib.LAUNCHES)
    q = kg.make_circuit2d_grid_probs_fn(n, L, ansatz, edges)(p)
    g, = torch.autograd.grad(q @ v, p)
    assert _lib.LAUNCHES == before  # CPU tensors run the plain versions
    r = th.clone().requires_grad_(True)
    ref = _oracle(n, L, ansatz, edges)(r)
    g_ref, = torch.autograd.grad(ref @ v, r)
    if dtype == F64:
        np.testing.assert_allclose(q.detach().numpy(), ref.detach().numpy(), atol=1e-12, rtol=0)
        np.testing.assert_allclose(g.numpy(), g_ref.numpy(), atol=1e-10, rtol=0)
    else:
        assert q.dtype == F32 and g.dtype == F32
        assert float((q - ref).abs().max() / ref.abs().max()) <= 2e-6
        assert float((g - g_ref).abs().max() / g_ref.abs().max()) <= 2e-5


def _dense_fn(n, L, ansatz, edges, conditioning, reupload):
    """The operator-plane path of the same circuit under ``highest``: the
    dense Kronecker fold and the plain ``Circuit2dGridFunction``."""
    plan = kg.GridPlan(n, L, ansatz, edges)
    return make_probs_fn(plan, lambda Mr, Mc: kg.grid_planes(Mr, Mc, plan),
                         kg.Circuit2dGridFunction, kg.circuit2d_grid_forward, conditioning,
                         reupload)


WALL_CASES = {"no-wall": ("basic", False, False, None), "one-wall": (HE, True, False, None),
              "reupload": (BN, True, True, None), "reupload-per-layer": (BN, True, True, "L"),
              "batch": (HE, True, False, "batch"), "batch-reupload": (BN, True, True, "batch")}


@pytest.mark.parametrize("case", list(WALL_CASES))
@pytest.mark.parametrize("n", [5, 8])
def test_gate_path_dtheta_matches_the_dense_plain_path(case, n):
    ansatz, conditioning, reupload, form = WALL_CASES[case]
    L = 3
    edges = _edges(n) if ansatz == BN else None
    th = _theta(n, L, ansatz, seed=2 * n)
    rng = np.random.default_rng(n + 1)
    if form == "L":
        angles = torch.as_tensor(rng.uniform(0, np.pi, (L, n)))
    else:
        angles = torch.as_tensor(rng.uniform(0, np.pi, n))
    walls = [angles, torch.as_tensor(rng.uniform(0, np.pi, n))]
    v = torch.as_tensor(rng.normal(size=(2, 2**n)))
    out = []
    for fn in (kg.make_circuit2d_grid_probs_fn(n, L, ansatz, edges, conditioning, reupload),
               _dense_fn(n, L, ansatz, edges, conditioning, reupload)):
        p = th.clone().requires_grad_(True)
        if form == "batch":
            q = fn.batch(p, walls)
            loss = (q * v).sum()
        else:
            q = fn(p, angles) if conditioning else fn(p)
            loss = q @ v[0]
        g, = torch.autograd.grad(loss, p)
        out.append((q.detach(), g))
    (q, g), (q_ref, g_ref) = out
    np.testing.assert_allclose(q.numpy(), q_ref.numpy(), atol=1e-12, rtol=0)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), atol=1e-10, rtol=0)


@pytest.mark.parametrize("precision,path", [("highest", "gates"), ("high", "operators"),
                                            ("default", "operators")])
def test_dispatch_follows_the_plan_precision(precision, path, kernel_precision, monkeypatch):
    calls = {"gates": 0, "operators": 0}

    def counting(name, apply):
        def wrapped(*args):
            calls[name] += 1
            return apply(*args)
        return wrapped

    monkeypatch.setattr(kg.CircuitGatesFunction, "apply",
                        counting("gates", kg.CircuitGatesFunction.apply))
    monkeypatch.setattr(kg.Circuit2dGridFunction, "apply",
                        counting("operators", kg.Circuit2dGridFunction.apply))
    kernel_precision(precision)
    n, L = 5, 2
    fn = kg.make_circuit2d_grid_probs_fn(n, L, HE)
    th = _theta(n, L, HE, seed=1)
    q = fn(th)
    st = fn.state(th)
    assert calls == {"gates": int(path == "gates"), "operators": int(path == "operators")}
    np.testing.assert_allclose((st.abs() ** 2).numpy(), q.numpy(), atol=1e-12, rtol=0)
    if path == "gates":
        np.testing.assert_allclose(q.numpy(), ansatz_probs(th, n, L, HE).numpy(), atol=1e-12)


@pytest.mark.parametrize("n,precision,ok", [
    (24, "high", True), (24, "default", True), (25, "high", False), (25, "default", False),
    (25, "highest", True), (28, "highest", True), (30, "highest", True), (31, "highest", False)])
def test_each_path_has_its_own_range(n, precision, ok):
    """The gate path (``highest``) plans to the 32-bit index's 30 qubits;
    the operator path (``high``, ``default``) stops at 24."""
    assert kg.max_qubits(precision) == (kg.GATE_MAX_QUBITS if precision == "highest"
                                        else kg.MAX_QUBITS)
    assert kg.max_qubits(precision, F64) == kg.MAX_QUBITS  # the gate kernels are FP32
    if ok:
        assert kg.GridPlan(n, 2, HE, precision=precision).precision == precision
    else:
        with pytest.raises(ValueError, match="circuit2d_grid supports"):
            kg.GridPlan(n, 2, HE, precision=precision)


@pytest.mark.parametrize("n,ansatz,L", [(28, HE, 4), (28, BN, 8), (30, HE, 4)])
def test_wide_plans_build_no_dense_operator(n, ansatz, L):
    """Past 24 qubits a ``highest`` plan holds its passes alone, at most four
    a layer, every tile within 4096 amplitudes; neither the banks nor the
    operator planes of the dense path are built, and asking for them
    raises."""
    plan = kg.GridPlan(n, L, ansatz, _edges(n, seed=11)[:-1] if ansatz == BN else None,
                       precision="highest")
    passes = plan.gate_passes()
    assert len(passes) <= 4 * L and all(ps.k <= kg.GATE_TILE_BITS for ps in passes)
    assert plan.gate_partials() == sum(len(ps.gates) << (n - ps.k) for ps in passes)
    assert not any(isinstance(k, tuple) and k[0] == "banks" for k in plan._cache)
    with pytest.raises(ValueError, match="dense operators"):
        plan.banks("cpu", torch.float32)
    with pytest.raises(ValueError, match="dense operators"):
        kg.grid_operators(torch.zeros(num_ansatz_params(n, L, ansatz)), plan)
    assert not any(isinstance(k, tuple) and k[0] == "banks" for k in plan._cache)


@pytest.mark.parametrize("cond", [0, 1])
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("n", [24, 25, 28, 30, 31])
def test_auto_backend_takes_the_gate_path_to_30_qubits(n, precision, dtype, cond,
                                                       kernel_precision):
    """``auto``: the grid kernels at 18-24 qubits whatever the machine; from
    25 to 30 for an FP32 machine under ``highest`` (the gate path), else
    the blocked executor, as past 30. ``auto_backend`` gives the engines the
    same choice."""
    kernel_precision(precision)
    m = QuantumBornMachine(n, 2, HE, dtype=dtype, device="cpu", conditioning_dim=cond)
    gates = n <= kg.MAX_QUBITS or (n <= kg.GATE_MAX_QUBITS and precision == "highest"
                                   and dtype == F32)
    assert m.backend == ("circuit2d_grid" if gates else "blocked")
    assert auto_backend(n, HE, dtype, bool(cond)) == m.backend
    if m.backend == "circuit2d_grid":
        assert m.grad_method == "autodiff"
