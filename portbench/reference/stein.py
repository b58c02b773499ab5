"""Plain float64 kernelized Stein discrepancy over {0,1}^n.

The discrete Stein kernel of a base kernel k and a score s (Yang et al.,
ICML 2018, with the flip as the cyclic shift of a binary variable):

    k_p(x, y) = sum_m [ s_m(x) s_m(y) k(x, y)
                        - s_m(x) (k(x, y) - k(x, flip_m y))
                        - s_m(y) (k(x, y) - k(flip_m x, y))
                        + k(x, y) - k(flip_m x, y) - k(x, flip_m y) + k(x, y) ]

with the Hamming kernel k(x, y) = a^d(x, y), a = exp(-1 / (n l)). Over all
2^n states K = A^(kron n), A = [[1, a], [a, 1]], and K commutes with every
flip F_m, so with P0 = K q and Q_m = K (s_m q):

    (K_p q) = sum_m [ s_m Q_m - s_m (P0 - F_m P0) - (Q_m - F_m Q_m)
                      + 2 (P0 - F_m P0) ]

``exact_matvec`` computes that with n+1 Kronecker applications, one bit at
a time. ``gram`` is the same kernel on sample rows, pair by pair.
"""

from __future__ import annotations

import math

import torch


def decay(n: int, length_scale: float) -> float:
    return math.exp(-1.0 / (n * length_scale))


def kron_apply(V: torch.Tensor, a: float, n: int) -> torch.Tensor:
    """A^(kron n) on every row of V (rows, 2^n)."""
    rows = V.shape[0]
    for m in range(n):
        x = V.view(rows, 1 << m, 2, -1)
        V = torch.stack([x[:, :, 0] + a * x[:, :, 1], a * x[:, :, 0] + x[:, :, 1]],
                        dim=2).view(rows, -1)
    return V


def flip(v: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """v at every index with bit m (qubit m, MSB-first) flipped."""
    return v.view(1 << m, 2, -1).flip(1).reshape(-1)


def exact_matvec(q: torch.Tensor, scores, n: int, length_scale: float,
                 block: int = 8) -> torch.Tensor:
    """K_p q for q (2^n,) float64; ``scores(m)`` gives the column s_m."""
    a = decay(n, length_scale)
    P0 = kron_apply(q[None], a, n)[0]
    y = torch.zeros_like(q)
    for m in range(n):
        y += 2.0 * (P0 - flip(P0, m, n))
    for start in range(0, n, block):
        ms = range(start, min(start + block, n))
        S = torch.stack([scores(m) for m in ms])
        Q = kron_apply(S * q, a, n)
        for k, m in enumerate(ms):
            y += S[k] * Q[k] - S[k] * (P0 - flip(P0, m, n)) - (Q[k] - flip(Q[k], m, n))
        del S, Q
    return y


def gram(S: torch.Tensor, Z: torch.Tensor, n: int, length_scale: float) -> torch.Tensor:
    """(M, M) k_p over sample rows Z (M, n) of 0/1 with scores S (M, n)."""
    a = decay(n, length_scale)
    diff = (Z[:, None, :] != Z[None, :, :]).to(S.dtype)          # (M, M, n)
    k = torch.pow(torch.tensor(a, dtype=S.dtype, device=S.device), diff.sum(-1))
    # k(x, flip_m y) / k(x, y) = a^(1 - 2 [x_m != y_m]), and so is k(flip_m x, y).
    r = 1.0 - torch.pow(torch.tensor(a, dtype=S.dtype, device=S.device), 1.0 - 2.0 * diff)
    w = (S[:, None, :] * S[None, :, :] - (S[:, None, :] + S[None, :, :]) * r + 2.0 * r).sum(-1)
    return k * w
