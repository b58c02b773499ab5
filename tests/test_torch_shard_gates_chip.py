"""The lean distributed executor's kernels on the card (``csrc/circuit_gates.cu``
through ``ops/kernels/shard_gates.py``), and the executor itself.

- The one-card gate kernels (kernels 5-6 under ``highest``) at n = 20 and 24
  give outputs bit-equal to those of ``circuit_gates.cu`` before a pass
  record had a shard's fields (commit 2b6af36): the SHA-256 of each output
  is held in ``fixtures/circuit_gates_digests.json``, read from that
  commit's kernels on an H100 (nvcc 12, sm_90a) on the inputs made here
  from fixed seeds. The test fails where the file is missing. Another
  toolchain may round differently: then rebuild the file from that
  commit's kernels on the new toolchain before judging a change.
- A 30-bit shard plan (n = 32 on four ranks, rank 3: a constant XOR and
  the rank's CZ signs in the map pass's store) against its plain version on
  sampled blocks of every pass, and each pass un-computed by its adjoint;
  a 24-bit one against its plain version whole, the adjoint's dU too.
- The executor on four gloo ranks sharing one card at n = 26 (each
  exchange in pieces) against the float64 reference of the benchmark, for
  a loss whose cotangent lives on 1024 states, as the sampled estimator's
  does (a dense random cotangent makes the θ-gradient a sum over 2^26
  terms that cancel, whose FP32 error grows as their square root).
- With four cards: ``sampled_he4`` on the distributed engine at n = 24
  (``n24.obs2``) through the benchmark's harness, its rate printed; and the
  executor's θ-gradient at n = 28 and 32 on four NCCL ranks against the
  float64 reference in four blocks, for a REINFORCE-like cotangent, equal
  bit for bit at every piece size.

These tests need a CUDA card and skip without one. Without the JAX package
(the tests' conftest imports it): ``python -m pytest
tests/test_torch_shard_gates_chip.py -m chip --noconftest -q -s``.
"""

import ctypes
import hashlib
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tensornetworks_tpu_torch.ops.kernels import _lib
from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg
from tensornetworks_tpu_torch.ops.kernels import shard_gates as sg
from tensornetworks_tpu_torch.parallel.distributed_ansatz import ShardProgram
from tensornetworks_tpu_torch.sim.gates import layer_rotations

pytestmark = pytest.mark.chip

REPO = Path(__file__).resolve().parents[1]
HE, BN = "hardware_efficient", "bn_structured"


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _edges(n, seed=7):
    rng = np.random.default_rng(seed)
    return [(int(p), c) for c in range(1, n)
            for p in rng.choice(c, size=min(c, int(rng.integers(0, 3))), replace=False)]


def _rel(a, b, piece=1 << 24):
    """max |a - b| / max |b|, over the last dimension in pieces."""
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    gap = big = 0.0
    for s in range(0, b.shape[-1], piece):
        x, y = a[:, s:s + piece].double(), b[:, s:s + piece].double()
        gap, big = max(gap, float((x - y).abs().max())), max(big, float(y.abs().max()))
    return gap / big


def _gates(n, L, per_qubit, seed, device):
    rng = np.random.default_rng(seed)
    th = torch.as_tensor(rng.uniform(0, 2 * np.pi, per_qubit * n * L), dtype=torch.float32,
                         device=device)
    return layer_rotations(th, n, L, per_qubit).contiguous()


DIGESTS = REPO / "tests" / "fixtures" / "circuit_gates_digests.json"
ONE_CARD_CASES = [(20, HE, 4), (24, HE, 4), (24, BN, 8)]


def one_card_inputs(n, ansatz, L):
    """The plan, gates U and cotangent g (on the CPU) of a one-card case."""
    plan = kg.GridPlan(n, L, ansatz, _edges(n) if ansatz == BN else None, precision="highest")
    U = _gates(n, L, plan.per_qubit, n + L, "cpu")
    g = torch.as_tensor(np.random.default_rng(3).normal(size=(plan.R, plan.C)),
                        dtype=torch.float32)
    return plan, U, g


def digests(outs) -> list:
    """The SHA-256 of each tensor's bytes."""
    return [hashlib.sha256(t.cpu().contiguous().numpy().tobytes()).hexdigest() for t in outs]


def _run_one_card(lib, U, g, plan):
    """circuit_gates_forward / _backward's launches with the library ``lib``."""
    dev = U.device
    u = torch.view_as_real(U.contiguous())
    probs = torch.empty((plan.R, plan.C), dtype=torch.float32, device=dev)
    xr, xi = torch.empty_like(probs), torch.empty_like(probs)
    tmp = torch.empty((2, plan.R, plan.C), dtype=torch.float32, device=dev)
    spec, slots = kg._gate_tables(plan, dev)
    rec = plan.gate_records()
    _lib.check(lib.tn_circuit_gates_forward(
        _lib.ptr(u), _lib.ptr(probs), _lib.ptr(xr), _lib.ptr(xi), _lib.ptr(tmp), _lib.ptr(spec),
        rec.ctypes.data_as(ctypes.c_void_p), len(rec), int(plan.has_wall),
        _lib.stream_ptr(dev)), "forward")
    du = torch.empty((plan.layers, plan.n, 2, 2, 2), dtype=torch.float32, device=dev)
    buf_a = torch.empty((4, plan.R, plan.C), dtype=torch.float32, device=dev)
    buf_b = torch.empty_like(buf_a)
    partials = torch.empty((plan.gate_partials(), 8), dtype=torch.float32, device=dev)
    _lib.check(lib.tn_circuit_gates_backward(
        _lib.ptr(u), _lib.ptr(xr), _lib.ptr(xi), _lib.ptr(g), _lib.ptr(du), _lib.ptr(buf_a),
        _lib.ptr(buf_b), _lib.ptr(partials), _lib.ptr(slots), _lib.ptr(spec),
        rec.ctypes.data_as(ctypes.c_void_p), len(rec), plan.layers * plan.n,
        _lib.stream_ptr(dev)), "backward")
    torch.cuda.synchronize(dev)
    return probs, xr, xi, du


@pytest.mark.parametrize("n,ansatz,L", ONE_CARD_CASES)
def test_one_card_gate_kernels_bit_equal_to_the_parent(n, ansatz, L, cuda):
    if not DIGESTS.exists():
        pytest.fail(f"{DIGESTS} is missing: the parent's outputs to hold the kernels against")
    plan, U, g = one_card_inputs(n, ansatz, L)
    assert not plan.gate_records()[:, 7].any()  # the shard's word is zero
    mine = _run_one_card(_lib.load("circuit_gates"), U.to(cuda), g.to(cuda), plan)
    assert digests(mine) == json.loads(DIGESTS.read_text())[f"{n}.{ansatz}.{L}"]


def _pass_plain_blocks(ps, U, x, blocks):
    """(dst, vals) of blocks of one forward pass, as ``gate_pass_forward_plain``."""
    src, dst, pos = kg.gate_pass_index(ps, x.device, blocks)
    tile = x[src]
    for t, q in ps.gates:
        tile = kg._apply_gate(tile, t, U[ps.layer, q])
    vals = tile.gather(1, pos)
    if ps.cz is not None or ps.negate:
        vals = vals * kg._store_sign(ps, dst, vals.real.dtype)
    return dst, vals


def test_shard_plan_on_30_local_bits(cuda):
    prog = ShardProgram(32, 1, HE, 2, 3)
    tables, _ = prog.tables(cuda)
    passes = tables[0].passes
    assert passes[-1].map and passes[-1].xor and passes[-1].cz is not None
    U = _gates(32, 1, 3, 5, cuda)[:, 2:].contiguous()
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((2, 1 << 30), generator=gen, device=cuda)
    y = torch.empty_like(x)
    partials = torch.empty((prog.records[0], 8), device=cuda)
    worst = 0.0
    for i, ps in enumerate(passes):
        sg.gates_forward_pass(tables[0], i, U, x, y)
        blocks = torch.randint(0, 1 << (30 - ps.k), (64,), generator=gen, device=cuda)
        dst, vals = _pass_plain_blocks(ps, U, torch.complex(x[0], x[1]), blocks)
        got = torch.complex(y[0][dst], y[1][dst])
        worst = max(worst, _rel(torch.view_as_real(got), torch.view_as_real(vals)))
        # the adjoint un-computes the pass
        back = torch.empty_like(x)
        lam = torch.zeros_like(x)
        if ps.map:
            sg.gates_backward_pass(tables[0], i, U, y, None, back, None, None, {}, two=True)
            sg.gates_backward_pass(tables[0], i, U, back, lam, back, lam, partials, {},
                                   nomap=True)
        else:
            back.copy_(y)
            sg.gates_backward_pass(tables[0], i, U, back, lam, back, lam, partials, {})
        assert _rel(back, x) < 1e-5
        del back, lam
        x, y = y, x
    assert worst < 1e-6, worst


def test_shard_plan_on_24_local_bits_whole(cuda):
    prog = ShardProgram(26, 2, HE, 2, 2)
    tables, slots = prog.tables(cuda)
    U = _gates(26, 2, 3, 9, cuda)[:, 2:].contiguous()
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 1 << 24), generator=gen, device=cuda)
    lam = torch.randn((2, 1 << 24), generator=gen, device=cuda)
    xc, lc = torch.complex(x[0], x[1]), torch.complex(lam[0], lam[1])
    Uh = U.conj().transpose(-1, -2)
    for layer, t in enumerate(tables):
        y = torch.empty_like(x)
        for i, ps in enumerate(t.passes):
            sg.gates_forward_pass(t, i, U, x, y if ps.map else x)
            if ps.map:
                x, y = y, x
            xc = kg.gate_pass_forward_plain(ps, U, xc)
        assert _rel(torch.view_as_real(torch.complex(x[0], x[1])), torch.view_as_real(xc)) < 1e-5
    for layer in reversed(range(len(tables))):
        t = tables[layer]
        partials = torch.empty((prog.records[layer], 8), dtype=torch.float32, device=cuda)
        parts = {}
        for i in reversed(range(len(t.passes))):
            ps = t.passes[i]
            if ps.map:
                s = torch.empty_like(x)
                sg.gates_backward_pass(t, i, U, x, None, s, None, None, {}, two=True)
                x = s
                s = torch.empty_like(lam)
                sg.gates_backward_pass(t, i, U, lam, None, s, None, None, {}, two=True)
                lam = s
                sg.gates_backward_pass(t, i, U, x, lam, x, lam, partials, {}, nomap=True)
            else:
                sg.gates_backward_pass(t, i, U, x, lam, x, lam, partials, {})
            xc, lc, p = kg.gate_pass_backward_plain(ps, Uh, xc, lc)
            parts.update(p)
        dU = sg.gates_reduce(partials, slots[layer], prog.nl)
        want = torch.stack([parts[layer, q] for q in range(prog.nl)])
        assert _rel(torch.view_as_real(dU), torch.view_as_real(want)) < 1e-4
    assert _rel(torch.view_as_real(torch.complex(x[0], x[1])), torch.view_as_real(xc)) < 1e-5


def test_lean_executor_on_one_card_against_the_reference(cuda):
    from tensornetworks_tpu_torch.parallel import spawn

    import torch_dist_ranks

    out = spawn(torch_dist_ranks.lean_executor_card_case, 4, "gloo", "cuda",
                {"n": 26, "layers": 4, "piece": 1 << 20, "seed": 11}, timeout_s=900)
    print(f"\nlean executor, n=26 on 4 gloo ranks of one card: {out}")
    assert out["q_rel"] < 2e-5 and out["grad_rel"] < 2e-4, out


def test_n24x4_on_four_cards(cuda):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    from portbench.harness import ROOT, find_cell, load_json, run_cell

    spec = find_cell("sampled_he4.n32x4")
    spec.traffic = load_json(ROOT / "traffic" / "n24.obs2.json")
    spec.limits = load_json(ROOT / "limits" / "sampled_he4.n24.json")
    res = run_cell(spec, 2147491021, 10.0, False, time.perf_counter(), log=print)
    rate = res["metrics"]["epochs_per_s"]["value"]
    print(f"\nn24x4 on the lean executor: {rate:.4f} epochs/s (the gate-by-gate executor "
          f"read 0.61), peak {res['device']['memory_peak_bytes_per_device']}, "
          f"checks {res['checks']}")
    assert res["correct"], res["checks"]


def test_lean_executor_gradient_at_32_qubits_on_four_cards(cuda):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    from tensornetworks_tpu_torch.parallel import spawn

    import torch_dist_ranks

    cases = [(28, [1 << 26, 1 << 22]), (32, [1 << 26, 1 << 26, 1 << 24])]
    out = spawn(torch_dist_ranks.lean_executor_grad_case, 4, "nccl", "cuda", {"cases": cases},
                timeout_s=1200)
    print(f"\nlean executor θ-gradient on four cards against float64: {out}")
    # within the cell's grad_rel limit (portbench/limits/sampled_he4.n32x4.json)
    for n, _ in cases:
        *reads, equal = out[n]
        assert all(r["max_rel"] < 1e-4 and r["norm_rel"] < 1e-4 for r in reads), out[n]
        assert all(equal["repeat_equal"]), out[n]
