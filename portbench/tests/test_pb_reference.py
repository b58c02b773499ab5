"""The plain reference against brute force at 3 to 6 qubits: dense
unitaries, the Stein kernel over all 2^n x 2^n pairs, finite differences."""

import itertools
import math

import numpy as np
import pytest
import torch

from portbench.reference.circuit import Circuit, entangler_gates, rotations
from portbench.reference.network import SCORE_EPS, Network
from portbench.reference.optim import Adam
from portbench.reference.sampled import surrogate_cotangent, two_stage_draws, ustat
from portbench.reference.stein import decay, exact_matvec, gram

ANSATZE = ("hardware_efficient", "bn_structured")


def edges_for(n):
    return [(0, 1), (0, 2), (1, n - 1)] if n > 2 else [(0, 1)]


def dense_gate(U, q, n):
    return np.kron(np.kron(np.eye(1 << q), U), np.eye(1 << (n - q - 1)))


def dense_perm(n, c, t):
    P = np.zeros((1 << n, 1 << n))
    for i in range(1 << n):
        j = i ^ (((i >> (n - 1 - c)) & 1) << (n - 1 - t))
        P[j, i] = 1.0
    return P


def dense_cz(n, a, b):
    return np.diag([-1.0 if (i >> (n - 1 - a)) & (i >> (n - 1 - b)) & 1 else 1.0
                    for i in range(1 << n)])


def dense_state(ansatz, n, L, theta, edges):
    U, _ = rotations(theta.reshape(L, n, 3))
    psi = np.full(1 << n, 2.0 ** (-n / 2), dtype=complex)
    for layer in range(L):
        for q in range(n):
            psi = dense_gate(U[layer, q], q, n) @ psi
        cnots, czs = entangler_gates(ansatz, n, layer, edges)
        for c, t in cnots:
            psi = dense_perm(n, c, t) @ psi
        for a, b in czs:
            psi = dense_cz(n, a, b) @ psi
    return psi


@pytest.mark.parametrize("ansatz", ANSATZE)
@pytest.mark.parametrize("n", [3, 4, 5])
def test_state_matches_dense_unitaries(ansatz, n):
    L = 3
    theta = np.random.default_rng(n).normal(size=3 * n * L)
    circ = Circuit(ansatz, n, L, edges_for(n))
    got = torch.cat(circ.state(theta)).numpy()
    np.testing.assert_allclose(got, dense_state(ansatz, n, L, theta, edges_for(n)), atol=1e-13)


@pytest.mark.parametrize("ansatz", ANSATZE)
def test_adjoint_gradient_matches_finite_differences(ansatz):
    n, L = 4, 3
    rng = np.random.default_rng(1)
    theta = rng.normal(size=3 * n * L)
    g = torch.as_tensor(rng.normal(size=1 << n))
    circ = Circuit(ansatz, n, L, edges_for(n))
    grad = circ.grad(theta, [g])
    h = 1e-6

    def loss(t):
        return float(g @ torch.cat(circ.probs(t)))

    fd = np.array([(loss(theta + h * e) - loss(theta - h * e)) / (2 * h)
                   for e in np.eye(theta.size)])
    np.testing.assert_allclose(grad, fd, atol=1e-8)


def random_network(rng, n, N):
    parents, cpts = [], []
    for i in range(N):
        k = min(i, int(rng.integers(0, 3)))
        ps = sorted(rng.choice(i, size=k, replace=False).tolist()) if k else []
        p1 = rng.uniform(0.05, 0.95, size=1 << k)
        parents.append(ps)
        cpts.append(np.stack([1 - p1, p1], axis=1))
    return parents, cpts, {i: int(rng.integers(0, 2)) for i in range(n, N)}


def brute_log_joint(parents, cpts, n, observed, z):
    vals = [(z >> (n - 1 - i)) & 1 for i in range(n)] + [observed[i] for i in sorted(observed)]
    lp = 0.0
    for i, ps in enumerate(parents):
        row = sum(vals[p] << (len(ps) - 1 - j) for j, p in enumerate(ps))
        lp += math.log(cpts[i][row, vals[i]])
    return lp


def test_log_joint_and_score_match_brute_force():
    rng = np.random.default_rng(3)
    n, N = 5, 7
    parents, cpts, obs = random_network(rng, n, N)
    net = Network(parents, cpts, n, obs)
    idx = torch.arange(1 << n)
    lp = net.log_joint(idx).numpy()
    want = np.array([brute_log_joint(parents, cpts, n, obs, z) for z in range(1 << n)])
    np.testing.assert_allclose(lp, want, rtol=1e-13)
    for m in range(n):
        s = net.score(idx, m).numpy()
        flipped = want[np.arange(1 << n) ^ (1 << (n - 1 - m))]
        ref = np.where(want < math.log(SCORE_EPS), 0.0, 1.0 - np.exp(flipped - want))
        np.testing.assert_allclose(s, ref, rtol=1e-12, atol=1e-15)


def dense_stein_gram(S, n, ls):
    """k_p over all pairs from its definition, flips taken explicitly."""
    a = decay(n, ls)
    N = 1 << n

    def k(x, y):
        return a ** bin(x ^ y).count("1")

    K = np.zeros((N, N))
    for x, y in itertools.product(range(N), range(N)):
        tot = 0.0
        for m in range(n):
            f = 1 << (n - 1 - m)
            kxy, kxfy, kfxy, kfxfy = k(x, y), k(x, y ^ f), k(x ^ f, y), k(x ^ f, y ^ f)
            tot += (S[x, m] * S[y, m] * kxy - S[x, m] * (kxy - kxfy) - S[y, m] * (kxy - kfxy)
                    + kxy - kfxy - kxfy + kfxfy)
        K[x, y] = tot
    return K


@pytest.mark.parametrize("n", [3, 4, 5, 6])
def test_exact_matvec_matches_dense_stein_gram(n):
    rng = np.random.default_rng(n)
    S = rng.normal(size=(1 << n, n))
    q = rng.random(1 << n)
    q /= q.sum()
    ls = 0.7
    St = torch.as_tensor(S)
    y = exact_matvec(torch.as_tensor(q), lambda m: St[:, m], n, ls, block=3).numpy()
    np.testing.assert_allclose(y, dense_stein_gram(S, n, ls) @ q, rtol=1e-11, atol=1e-13)


def test_sample_gram_matches_dense_stein_gram():
    n, ls = 4, 1.3
    rng = np.random.default_rng(5)
    S = rng.normal(size=(1 << n, n))
    K = dense_stein_gram(S, n, ls)
    idx = torch.as_tensor(rng.integers(0, 1 << n, size=9))
    Z = (idx[:, None] >> torch.arange(n - 1, -1, -1)) & 1
    G = gram(torch.as_tensor(S)[idx], Z, n, ls).numpy()
    np.testing.assert_allclose(G, K[np.ix_(idx.numpy(), idx.numpy())], rtol=1e-12, atol=1e-13)
    M = len(idx)
    np.testing.assert_allclose(float(ustat(torch.as_tensor(G))),
                               (G.sum() - np.trace(G)) / (M * (M - 1)), rtol=1e-14)


def test_two_stage_draws_are_the_first_step_above_each_uniform():
    n = 5
    rng = np.random.default_rng(2)
    q = torch.as_tensor(rng.random(1 << n))
    q /= q.sum()
    u_r = torch.as_tensor(rng.random(200), dtype=torch.float32)
    u_c = torch.as_tensor(rng.random(200), dtype=torch.float32)
    idx = two_stage_draws([q], u_r, u_c, n).numpy()
    P = q.numpy().reshape(8, 4) + 1e-10
    cr = np.cumsum(P.sum(1)) / P.sum()
    for i, j in enumerate(idx):
        r, c = divmod(int(j), 4)
        assert cr[r] > u_r[i] and (r == 0 or cr[r - 1] <= u_r[i])
        cc = np.cumsum(P[r]) / P[r].sum()
        assert cc[c] > u_c[i] and (c == 0 or cc[c - 1] <= u_c[i])


def test_surrogate_cotangent_matches_autograd():
    rng = np.random.default_rng(4)
    M, K = 7, 16
    G = torch.as_tensor(rng.normal(size=(M, M)))
    G = G + G.T
    idx = torch.as_tensor([1, 3, 3, 5, 8, 12, 15])
    q = torch.tensor(rng.random(K), requires_grad=True)
    row = G.sum(1) - torch.diagonal(G)
    w = row / (M - 1) - (row.sum() - 2 * row) / ((M - 1) * (M - 2))
    (2.0 * (w * torch.log(q[idx])).mean()).backward()
    (got,) = surrogate_cotangent(G, idx, [q.detach()])
    np.testing.assert_allclose(got.numpy(), q.grad.numpy(), rtol=1e-13)


def test_adam_first_steps_by_hand():
    opt = Adam(lr=0.05, epochs=3, clip=10.0)
    theta = np.zeros(3)
    g = np.array([3.0, -40.0, 1e-3])
    gc = g * 10.0 / np.sqrt((g * g).sum())   # clipped to norm 10
    # With the same gradient every step, bias-corrected Adam moves each
    # coordinate by lr_t * g / (|g| + eps); lr_t follows the cosine from 0.05.
    unit = gc / (np.abs(gc) + 1e-8)
    t1 = opt.step(theta, g)
    np.testing.assert_allclose(t1, -0.05 * unit, rtol=1e-12)
    lr2 = 0.005 + 0.045 * 0.5 * (1 + math.cos(math.pi / 3))
    t2 = opt.step(t1, g)
    np.testing.assert_allclose(t2 - t1, -lr2 * unit, rtol=1e-9)
