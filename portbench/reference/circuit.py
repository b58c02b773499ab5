"""Plain float64 statevector of the benchmark's circuits, gate by gate, with
an adjoint backward.

The state is a flat (2^n,) complex128 vector, qubit 0 the most significant
bit of the index. Every circuit starts from the uniform state (the Hadamard
wall on |0...0>) and then runs ``layers`` layers of:

1. on every qubit q the fused rotation U = RZ(az)·RY(ay)·RX(ax), with
   RX(a) = [[c, -is], [-is, c]], RY(a) = [[c, -s], [s, c]],
   RZ(a) = diag(e^(-ia/2), e^(ia/2)), c, s = cos, sin(a/2), angles laid out
   (layer, qubit, (ax, ay, az));
2. the layer's entanglers:
   - ``hardware_efficient``: CNOT(q, q+1) for q = 0..n-2, then CNOT(n-1, 0)
     when n > 2, then on even layers CZ(q, q+2) for q = 0, 2, .. < n-2;
   - ``bn_structured``: along every edge (parent, child) in the given
     order, CNOT(parent -> child) on even layers, CZ on odd layers.

A layer's CNOTs are one index permutation and its CZs one sign vector,
both built once per circuit. The backward is the adjoint sweep: the final
state is un-computed gate by gate with U^dagger while the cotangent
lambda = g * psi is carried back, and each rotation's three angle
gradients are 2 Re sum_ab dU_ab M_ab with M_ab = <lambda_a, psi_b> over the
qubit's two halves. Nothing here reads the program under test.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def rotations(theta: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(U, dU) of angles (L, n, 3): U (L, n, 2, 2) and its three angle
    derivatives dU (L, n, 3, 2, 2), complex128 on the host."""
    h = np.asarray(theta, dtype=np.float64) / 2.0
    c, s = np.cos(h), np.sin(h)
    z = np.zeros_like(c[..., 0])

    def mat(a, b, d, e):
        return np.stack([np.stack([a, b], -1), np.stack([d, e], -1)], -2)

    cx, sx, cy, sy, cz, sz = c[..., 0], s[..., 0], c[..., 1], s[..., 1], c[..., 2], s[..., 2]
    rx = mat(cx + 0j, -1j * sx, -1j * sx, cx + 0j)
    ry = mat(cy + 0j, -sy + 0j, sy + 0j, cy + 0j)
    rz = mat(cz - 1j * sz, z + 0j, z + 0j, cz + 1j * sz)
    drx = 0.5 * mat(-sx + 0j, -1j * cx, -1j * cx, -sx + 0j)
    dry = 0.5 * mat(-sy + 0j, -cy + 0j, cy + 0j, -sy + 0j)
    drz = 0.5 * mat(-sz - 1j * cz, z + 0j, z + 0j, -sz + 1j * cz)
    U = rz @ ry @ rx
    dU = np.stack([rz @ ry @ drx, rz @ dry @ rx, drz @ ry @ rx], axis=-3)
    return U, dU


def entangler_gates(ansatz: str, n: int, layer: int,
                    edges: Sequence[Tuple[int, int]] = ()) -> Tuple[list, list]:
    """(CNOTs, CZs) of one layer, each a list of qubit pairs in order."""
    if ansatz == "hardware_efficient":
        cnots = [(q, q + 1) for q in range(n - 1)] + ([(n - 1, 0)] if n > 2 else [])
        czs = [(q, q + 2) for q in range(0, n - 2, 2)] if layer % 2 == 0 and n > 2 else []
        return cnots, czs
    if ansatz == "bn_structured":
        edges = [(int(a), int(b)) for a, b in edges]
        return (edges, []) if layer % 2 == 0 else ([], edges)
    raise ValueError(f"no reference circuit for ansatz {ansatz!r}")


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
