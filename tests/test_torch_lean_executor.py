"""The memory-lean distributed adjoint executor (``parallel/distributed_ansatz.py``,
its passes and pair combines in ``ops/kernels/shard_gates.py``).

One spawn of 4 gloo ranks on the CPU runs every case, on the dp=1 mesh (4
state shards) and the dp=2 mesh (2) of that world, in complex64 and
complex128, at 6 to 10 qubits, for every ansatz the factory takes. Each
case holds the executor's q and θ-gradient (of Σ w·q, summed over the
ranks) against the gate-by-gate form (autograd through ``shard_state``'s
primitives, ``tests/torch_dist_ranks.gate_by_gate_probs``) and, for the
ansätze it has, against the float64 reference that decides the
benchmark's ``correct`` (``portbench/reference/circuit.py``, the state in
D blocks). Cases with a small ``piece`` move each exchange in several
pieces. The executor saves one shard for its backward where the
gate-by-gate form saves one a gate, and the benchmark's planted faults
``exchange_self`` and ``altered_q`` change its output."""

import numpy as np
import pytest

from tensornetworks_tpu_torch.parallel import spawn

import torch_dist_ranks

ANSATZE = {"hardware_efficient": 3, "basic": 2, "all_to_all": 3, "bn_structured": 3}
REFERENCE = ("hardware_efficient", "bn_structured")
TOL = {"complex64": 1e-5, "complex128": 1e-12}


def _cases():
    rng = np.random.default_rng(21)
    cases = []
    for ansatz, per_qubit in ANSATZE.items():
        for dp in (1, 2):
            for dtype in ("complex128", "complex64"):
                n = 6 + len(cases) % 5
                edges = None
                if ansatz == "bn_structured":  # edges between global and local qubits both ways
                    edges = [(0, 1), (2, 0), (1, 3), (0, 4), (n - 1, 1), (3, 5), (1, 0)]
                cases.append({"name": f"{ansatz}/D{4 // dp}/{dtype}", "n": n, "layers": 3,
                              "ansatz": ansatz, "dp": dp, "dtype": dtype, "edges": edges,
                              "w": rng.random(1 << n),
                              "theta": rng.normal(size=per_qubit * n * 3),
                              "piece": 4 if dtype == "complex64" else 1 << 26,
                              "reference": ansatz in REFERENCE})
    cases.append({"name": "saved", "n": 10, "layers": 4, "ansatz": "hardware_efficient",
                  "dp": 1, "dtype": "complex64", "w": rng.random(1 << 10),
                  "theta": rng.normal(size=3 * 10 * 4), "saved": True, "faults": True})
    return cases


CASES = _cases()
NAMES = [c["name"] for c in CASES if c["name"] != "saved"]


@pytest.fixture(scope="module")
def out():
    return spawn(torch_dist_ranks.lean_executor_cases, 4, "gloo", "cpu", {"cases": CASES},
                 timeout_s=300)


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("name", NAMES)
def test_lean_executor_matches_gate_by_gate(out, name):
    (q, g), (q_gbg, g_gbg) = out[name]["lean"], out[name]["gbg"]
    tol = TOL[name.rsplit("/", 1)[1]]
    _close(q, q_gbg, tol)
    _close(g, g_gbg, tol)
    assert abs(q.sum() - 1.0) < 10 * tol


@pytest.mark.parametrize("name", [n for n in NAMES if n.split("/")[0] in REFERENCE])
def test_lean_executor_matches_float64_reference(out, name):
    (q, g), (q_ref, g_ref) = out[name]["lean"], out[name]["ref"]
    tol = TOL[name.rsplit("/", 1)[1]]
    _close(q, q_ref, tol)
    _close(g, g_ref, tol)


def test_lean_executor_saves_one_shard(out):
    """Tensors of a shard's size or more that autograd keeps for the
    backward: one (ψ) for the executor, one a gate for the gate-by-gate form."""
    lean, gbg = out["saved"]["saved"]
    assert lean == 1
    assert gbg > 100


@pytest.mark.parametrize("fault", ["exchange_self", "altered_q"])
def test_planted_faults_change_the_executor_output(out, fault):
    q = out["saved"]["lean"][0]
    assert np.abs(out["saved"][fault] - q).max() > 1e-5 * q.max()
