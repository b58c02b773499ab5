"""The reference's one-block code as it stood before the state was held
in blocks: the whole (2^n,) state on one device, each layer's CNOTs one
index permutation and its CZs one sign vector. The blocked reference is
held against it (``test_pb_blocks.py``)."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from portbench.reference.circuit import entangler_gates, rotations
from portbench.reference.sampled import CDF_EPS, LOG_FLOOR


class Circuit:
    """One circuit's static structure on a device: per layer the gather
    indices of its CNOT permutation (forward and inverse) and its CZ sign
    vector, shared by the layers that have the same entanglers."""

    def __init__(self, ansatz: str, n: int, layers: int, edges=(), device="cpu"):
        self.ansatz, self.n, self.layers = ansatz, n, layers
        self.device = torch.device(device)
        cache = {}
        self.ents: List[tuple] = []
        for layer in range(layers):
            key = entangler_gates(ansatz, n, layer, edges)
            tkey = (tuple(key[0]), tuple(key[1]))
            if tkey not in cache:
                cache[tkey] = (self._permutation(key[0]), self._signs(key[1]))
            self.ents.append(cache[tkey])

    def _bit(self, q: int) -> int:
        return 1 << (self.n - 1 - q)

    def _permutation(self, cnots):
        """(inv, fwd) with CNOTs(psi) = psi[inv] and psi = CNOTs(psi)[fwd],
        or None: a CNOT maps basis index i to i ^ (bit_c(i) * bit_t)."""
        if not cnots:
            return None
        idx = torch.arange(1 << self.n, dtype=torch.int64, device=self.device)

        def apply(order):
            j = idx.clone()
            for c, t in order:
                j ^= ((j & self._bit(c)) != 0).to(torch.int64) * self._bit(t)
            return j

        # out[j] = in[f^-1(j)]; f^-1 applies the (involutive) CNOTs in reverse.
        return apply(list(reversed(cnots))), apply(cnots)

    def _signs(self, czs):
        if not czs:
            return None
        idx = torch.arange(1 << self.n, dtype=torch.int64, device=self.device)
        odd = torch.zeros_like(idx, dtype=torch.bool)
        for a, b in czs:
            odd ^= ((idx & self._bit(a)) != 0) & ((idx & self._bit(b)) != 0)
        return 1.0 - 2.0 * odd.to(torch.float64)

    def apply_1q(self, psi: torch.Tensor, U, q: int) -> torch.Tensor:
        """The 2x2 operator U (complex numbers) on qubit q."""
        x = psi.view(1 << q, 2, -1)
        out = torch.empty_like(x)
        out[:, 0] = U[0][0] * x[:, 0] + U[0][1] * x[:, 1]
        out[:, 1] = U[1][0] * x[:, 0] + U[1][1] * x[:, 1]
        return out.view(-1)

    def entangle(self, psi: torch.Tensor, layer: int, inverse: bool = False) -> torch.Tensor:
        perm, signs = self.ents[layer]
        if not inverse:
            if perm is not None:
                psi = psi[perm[0]]
            return psi if signs is None else psi * signs
        if signs is not None:
            psi = psi * signs
        return psi if perm is None else psi[perm[1]]

    def state(self, theta: np.ndarray) -> torch.Tensor:
        """psi(theta), (2^n,) complex128."""
        U, _ = rotations(np.asarray(theta).reshape(self.layers, self.n, 3))
        psi = torch.full((1 << self.n,), 2.0 ** (-0.5 * self.n), dtype=torch.complex128,
                         device=self.device)
        for layer in range(self.layers):
            for q in range(self.n):
                psi = self.apply_1q(psi, U[layer, q].tolist(), q)
            psi = self.entangle(psi, layer)
        return psi

    def probs(self, theta: np.ndarray) -> torch.Tensor:
        psi = self.state(theta)
        return psi.real ** 2 + psi.imag ** 2

    def grad(self, theta: np.ndarray, g: torch.Tensor, psi: torch.Tensor = None) -> np.ndarray:
        """dL/dtheta (L*n*3,) float64 for a loss L(q) with dL/dq = g, by the
        adjoint sweep from the final state psi (recomputed when not given)."""
        L, n = self.layers, self.n
        U, dU = rotations(np.asarray(theta).reshape(L, n, 3))
        Uh = np.conj(np.swapaxes(U, -1, -2))
        psi = self.state(theta) if psi is None else psi
        lam = g.to(torch.float64) * psi
        out = np.zeros((L, n, 3))
        for layer in reversed(range(L)):
            psi = self.entangle(psi, layer, inverse=True)
            lam = self.entangle(lam, layer, inverse=True)
            for q in reversed(range(n)):
                psi = self.apply_1q(psi, Uh[layer, q].tolist(), q)
                xl, xp = lam.view(1 << q, 2, -1), psi.view(1 << q, 2, -1)
                M = np.array([[complex((xl[:, a].conj() * xp[:, b]).sum()) for b in range(2)]
                              for a in range(2)])
                out[layer, q] = 2.0 * np.real((dU[layer, q] * M).sum(axis=(-2, -1)))
                lam = self.apply_1q(lam, Uh[layer, q].tolist(), q)
        return out.reshape(-1)


def two_stage_draws(q: torch.Tensor, u_r: torch.Tensor, u_c: torch.Tensor,
                    n: int) -> torch.Tensor:
    rb = (n + 1) // 2
    R, C = 1 << rb, 1 << (n - rb)
    P = q.view(R, C) + CDF_EPS
    cdf_r = torch.cumsum(P.sum(dim=1), 0)
    cdf_r = cdf_r / cdf_r[-1]
    r = torch.searchsorted(cdf_r, u_r.to(torch.float64), right=True).clamp(0, R - 1)
    cdf_c = torch.cumsum(P[r], 1)
    cdf_c = cdf_c / cdf_c[:, -1:]
    c = torch.searchsorted(cdf_c, u_c.to(torch.float64)[:, None], right=True)[:, 0]
    return r * C + c.clamp(0, C - 1)


def surrogate_cotangent(G: torch.Tensor, idx: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """dL/dq (2^n,) of the surrogate at the shots ``idx`` (M,)."""
    M = G.shape[0]
    row = G.sum(dim=1) - torch.diagonal(G)
    coef = 2.0 / M * (row / (M - 1) - (row.sum() - 2.0 * row) / ((M - 1) * (M - 2)))
    qi = q[idx]
    coef = torch.where(qi > LOG_FLOOR, coef / qi, torch.zeros_like(coef))
    return torch.zeros_like(q).index_add_(0, idx, coef)
