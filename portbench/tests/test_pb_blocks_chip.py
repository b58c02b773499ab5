"""On four cards: the reference held in four blocks, one a card.

- At 32 qubits (sampled_he4's circuit, hardware_efficient L=4, 1024
  shots) ``check.follow`` runs what a run of a 32-qubit cell on four cards
  asks of it, three forwards and adjoints and one q, on a record of the
  program's shape; every card's peak stays within 75 GiB. It prints each
  card's peak and the seconds taken.
- At 32 qubits, where no card holds a second copy of the state, the
  four blocks give known answers: a product state (no entanglers) equals
  its closed form, a basis state goes through each layer's entanglers to
  the index and sign worked out on the host and back, q sums to 1, the
  adjoint gradient matches a central difference of the forward, and the
  adjoint sweep un-computes the state to the uniform one it started from.
- At 28 qubits four blocks on four cards agree with one block on one
  card: the state and q bit for bit, the adjoint gradient to 1e-12.
"""

import json
import time

import numpy as np
import pytest
import torch

from portbench.problem import make_problem
from portbench.reference.check import follow
from portbench.reference.circuit import Circuit, rotations
from portbench.tests.tiny import SRC

GIB = 2 ** 30


@pytest.fixture
def four_cards(cuda_device):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices; run on four chips")
    return [torch.device("cuda", i) for i in range(4)]


def _record(problem, devices, steps=3):
    """A record of the program's shape: its steps, shots and generator
    states, and q at the end as float32 blocks on the cards."""
    n, M = problem["n"], problem["num_samples"]
    gen = torch.Generator(device=devices[0]).manual_seed(7)
    states, shots = [], []
    for _ in range(steps):
        states.append(gen.get_state())
        shots.append(torch.randint(0, 1 << n, (M,), generator=gen, device=devices[0]).cpu())
        torch.rand(M, generator=gen, device=devices[0])
    block = (1 << n) // len(devices)
    return {"losses": [1.0] * steps, "grad_norms": [1.0] * steps,
            "theta_after": problem["theta0"], "after_steps": steps, "gen_states": states,
            "shots": [s.numpy() for s in shots], "theta_end": problem["theta0"],
            "q_end": [torch.full((block,), 2.0 ** -n, dtype=torch.float32, device=d)
                      for d in devices]}


@pytest.mark.chip
def test_the_reference_at_32_qubits_fits_four_cards(four_cards):
    config = json.loads((SRC / "configs" / "sampled_he4.json").read_text())
    traffic = json.loads((SRC / "traffic" / "n28.json").read_text())
    traffic.update(num_latent=32, num_vars=33, observed={"32": 1})
    problem = make_problem(config, traffic, 2**33 + 32)
    record = _record(problem, four_cards)
    for d in four_cards:
        torch.cuda.reset_peak_memory_stats(d)
    t = time.perf_counter()
    numbers = follow(problem, record, four_cards)
    for d in four_cards:
        torch.cuda.synchronize(d)
    seconds = time.perf_counter() - t
    peaks = [torch.cuda.max_memory_allocated(d) / GIB for d in four_cards]
    print(f"reference at n=32 on 4 cards: {seconds:.1f} s, peak GiB by card {peaks}, "
          f"numbers {numbers}")
    assert all(np.isfinite(v) for v in numbers.values())
    assert max(peaks) <= 75.0, peaks


def _norm_gap(blocks) -> float:
    return abs(sum(float((x.real ** 2 + x.imag ** 2).sum()) for x in blocks) - 1.0)


def _check_known_answers(cards, n=32, layers=4):
    """The checks of ``test_the_reference_at_32_qubits_gives_known_answers``
    on ``cards``; returns what it read."""
    rng = np.random.default_rng(n)
    block = (1 << n) // len(cards)
    k = len(cards).bit_length() - 1
    read = {}

    # A product state: bn_structured with no edges has no entanglers.
    theta = 0.3 * rng.normal(size=3 * n * layers)
    U, _ = rotations(theta.reshape(layers, n, 3))
    v = np.full((n, 2), 2 ** -0.5, dtype=complex)
    for layer in range(layers):
        v = np.einsum("qab,qb->qa", U[layer], v)
    psi = Circuit("bn_structured", n, layers, (), cards).state(theta)
    gaps, tops = [], []
    for b, d in enumerate(cards):
        lead = np.prod([v[q][(b >> (k - 1 - q)) & 1] for q in range(k)])
        want = torch.full((1,), complex(lead), dtype=torch.complex128, device=d)
        for q in range(k, n):
            want = torch.kron(want, torch.as_tensor(v[q], device=d))
        gaps.append(float((psi[b] - want).abs().max()))
        tops.append(float(want.abs().max()))
        del want
    read["product_gap"] = max(gaps) / max(tops)
    read["product_norm_gap"] = _norm_gap(psi)
    del psi

    # A basis state through each layer's entanglers, and back.
    circ = Circuit("hardware_efficient", n, layers, (), cards)
    x0 = int(rng.integers(0, 1 << n))
    bit = [1 << (n - 1 - q) for q in range(n)]
    for layer in (0, 1):
        blocks = [torch.zeros(block, dtype=torch.complex128, device=d) for d in cards]
        blocks[x0 // block][x0 % block] = 1.0
        x, sign = x0, 1.0
        cnots, czs = circ.ents[layer]
        for c, t in cnots:
            x ^= bit[t] if x & bit[c] else 0
        for a, b in czs:
            sign *= -1.0 if x & bit[a] and x & bit[b] else 1.0
        circ.entangle(blocks, layer)
        read[f"basis{layer}_value"] = complex(blocks[x // block][x % block])
        read[f"basis{layer}_norm_gap"] = _norm_gap(blocks)
        assert read[f"basis{layer}_value"] == sign, (layer, x0, x, sign)
        assert read[f"basis{layer}_norm_gap"] == 0.0
        circ.entangle(blocks, layer, inverse=True)
        assert complex(blocks[x0 // block][x0 % block]) == 1.0 and _norm_gap(blocks) == 0.0
        del blocks

    # The adjoint against a central difference of L = sum g q, and the
    # state un-computed by the adjoint sweep.
    theta = 0.1 * rng.normal(size=3 * n * layers)
    g = [torch.randn(block, generator=torch.Generator(device=d).manual_seed(b), device=d,
                     dtype=torch.float64) for b, d in enumerate(cards)]

    def loss(th):
        q = circ.probs(th)
        read.setdefault("norm_gaps", []).append(abs(sum(float(x.sum()) for x in q) - 1.0))
        return sum(float((x * y).sum()) for x, y in zip(q, g))

    psi = circ.state(theta)
    grad = circ.grad(theta, list(g), psi)
    read["uncompute_gap"] = max(float((x - 2 ** (-n / 2)).abs().max()) for x in psi) / 2 ** (-n / 2)
    del psi
    h, scale = 1e-4, float(np.abs(grad).max())
    read["fd_gaps"] = []
    for i in ((layers - 1) * 3 * n + 1, 3 * 20):   # (layer 3, qubit 0, ay), (0, 20, ax)
        up, down = theta.copy(), theta.copy()
        up[i] += h
        down[i] -= h
        fd = (loss(up) - loss(down)) / (2 * h)
        read["fd_gaps"].append(abs(fd - grad[i]) / scale)
    return read


@pytest.mark.chip
def test_the_reference_at_32_qubits_gives_known_answers(four_cards):
    for d in four_cards:
        torch.cuda.reset_peak_memory_stats(d)
    t = time.perf_counter()
    read = _check_known_answers(four_cards)
    peaks = [torch.cuda.max_memory_allocated(d) / GIB for d in four_cards]
    print(f"known answers at n=32 on 4 cards ({time.perf_counter() - t:.1f} s, peak GiB by "
          f"card {peaks}): {read}")
    assert read["product_gap"] <= 1e-12 and read["product_norm_gap"] <= 1e-12
    assert read["uncompute_gap"] <= 1e-12
    assert max(read["norm_gaps"]) <= 1e-12
    assert max(read["fd_gaps"]) <= 1e-6


@pytest.mark.chip
def test_four_blocks_on_four_cards_agree_with_one_block_at_28_qubits(four_cards):
    n, L = 28, 4
    rng = np.random.default_rng(28)
    theta = 0.1 * rng.normal(size=3 * n * L)
    one = Circuit("hardware_efficient", n, L, (), four_cards[:1])
    four = Circuit("hardware_efficient", n, L, (), four_cards)
    t = time.perf_counter()
    psi1 = one.state(theta)
    t1 = time.perf_counter() - t
    t = time.perf_counter()
    psi4 = four.state(theta)
    torch.cuda.synchronize(four_cards[0])
    t4 = time.perf_counter() - t
    size = (1 << n) // 4
    for b, x in enumerate(psi4):
        assert torch.equal(x.to(four_cards[0]), psi1[0][b * size:(b + 1) * size])
    gen = torch.Generator(device=four_cards[0]).manual_seed(3)
    g = [torch.randn(size, generator=gen, dtype=torch.float64, device=four_cards[0])
         for _ in range(4)]
    grad1 = one.grad(theta, [torch.cat(g)], psi1)
    grad4 = four.grad(theta, [x.to(d) for x, d in zip(g, four_cards)], psi4)
    print(f"n=28 forward: one card {t1:.2f} s, four cards {t4:.2f} s; gradient rel. gap "
          f"{np.abs(grad4 - grad1).max() / np.abs(grad1).max():.3e}")
    assert np.abs(grad4 - grad1).max() <= 1e-12 * np.abs(grad1).max()
    del psi1, psi4, g
    q1, q4 = one.probs(theta), four.probs(theta)
    for b, x in enumerate(q4):
        assert torch.equal(x.to(four_cards[0]), q1[0][b * size:(b + 1) * size])
