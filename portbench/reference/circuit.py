"""Plain float64 statevector of the benchmark's circuits, gate by gate, with
an adjoint backward, held in blocks.

The state of 2^n amplitudes, qubit 0 the most significant bit of the
index, is held as D = 2^k blocks: block b holds the 2^(n-k) amplitudes
whose leading k bits spell b, in the order of the remaining ("local")
bits, on the b-th of the circuit's devices (the same device for every
block on the CPU; D = 1 is the whole state on one device). No tensor of
length 2^n is built when D > 1: a gate on a local bit works inside each
block through views, a gate on one of the leading ("block") bits pairs
the blocks that differ in it with plain ``torch`` copies between their
devices, and a 2^n index permutation or sign vector is never formed.
Every gate works in place; with D > 1 blocks, in pieces of at most
``PIECE`` amplitudes, so that a block takes little more memory than itself
(at n = 32 on four cards a gate on whole 16-GiB blocks would want more
than a card holds, and whole-block gates that paired cards faulted there).
One block is worked on whole. The work of different blocks is queued on
their devices with no host sync in between.

Every circuit starts from the uniform state (the Hadamard wall on
|0...0>) and then runs ``layers`` layers of:

1. on every qubit q the fused rotation U = RZ(az)·RY(ay)·RX(ax), with
   RX(a) = [[c, -is], [-is, c]], RY(a) = [[c, -s], [s, c]],
   RZ(a) = diag(e^(-ia/2), e^(ia/2)), c, s = cos, sin(a/2), angles laid out
   (layer, qubit, (ax, ay, az));
2. the layer's entanglers, gate by gate:
   - ``hardware_efficient``: CNOT(q, q+1) for q = 0..n-2, then CNOT(n-1, 0)
     when n > 2, then on even layers CZ(q, q+2) for q = 0, 2, .. < n-2;
   - ``bn_structured``: along every edge (parent, child) in the given
     order, CNOT(parent -> child) on even layers, CZ on odd layers.

The backward is the adjoint sweep: the final state is un-computed gate by
gate with U^dagger while the cotangent lambda = g * psi is carried back,
and each rotation's three angle gradients are 2 Re sum_ab dU_ab M_ab with
M_ab = <lambda_a, psi_b> over the qubit's two halves. Nothing here reads
the program under test.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

# The most amplitudes one step of a gate touches in each of its operands,
# when the state is held in more than one block.
PIECE = 1 << 23


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


def pieces(shape: Sequence[int], limit: int):
    """Index tuples that cut a tensor of ``shape`` into parts of at most
    ``limit`` elements, in order (the whole tensor when ``limit`` is 0)."""
    total = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
    if not limit or total <= limit:
        yield ()
        return
    rest = int(np.prod(shape[1:], dtype=np.int64))
    if rest <= limit:
        step = limit // rest
        for s in range(0, shape[0], step):
            yield (slice(s, s + step),)
        return
    for i in range(shape[0]):
        for tail in pieces(shape[1:], limit):
            yield (i,) + tail


def fix_bits(x: torch.Tensor, bits: int, fixed: dict) -> torch.Tensor:
    """The view of a flat (2^bits,) ``x`` at the indices whose bits
    {position: value} (position 0 the most significant) are fixed."""
    shape, index, prev = [], [], 0
    for p in sorted(fixed):
        shape += [1 << (p - prev), 2]
        index += [slice(None), fixed[p]]
        prev = p + 1
    shape.append(1 << (bits - prev))
    return x.view(shape)[tuple(index)]


def _rotate(a: torch.Tensor, b: torch.Tensor, U, piece: int) -> None:
    """(a, b) <- (U00 a + U01 b, U10 a + U11 b) in place, ``piece``
    amplitudes at a time; ``b`` may live on another device."""
    for ix in pieces(a.shape, piece):
        x, y = a[ix], b[ix]
        yx, xy = y.to(a.device), x.to(b.device)
        n0 = U[0][0] * x + U[0][1] * yx
        n1 = U[1][0] * xy + U[1][1] * y
        x.copy_(n0)
        y.copy_(n1)


def _swap(a: torch.Tensor, b: torch.Tensor, piece: int) -> None:
    for ix in pieces(a.shape, piece):
        x, y = a[ix], b[ix]
        if a.device == b.device:
            t = x.clone()
            x.copy_(y)
            y.copy_(t)
        else:
            tx, ty = x.to(b.device), y.to(a.device)
            x.copy_(ty)
            y.copy_(tx)


def _inner(l: torch.Tensor, p: torch.Tensor, piece: int) -> torch.Tensor:
    """sum conj(l) * p as a 0-dim tensor on l's device, piece by piece."""
    parts = [(l[ix].conj() * p[ix].to(l.device)).sum() for ix in pieces(l.shape, piece)]
    return torch.stack(parts).sum()


class Circuit:
    """One circuit's static structure over the blocks on ``devices`` (one
    device, or one per block: D a power of two, at most 2^n)."""

    def __init__(self, ansatz: str, n: int, layers: int, edges=(), devices=("cpu",)):
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.devices = [torch.device(d) for d in devices]
        D = len(self.devices)
        self.k = D.bit_length() - 1
        if D != 1 << self.k or self.k > n:
            raise ValueError(f"{D} blocks: need a power of two of at most 2^{n}")
        self.ansatz, self.n, self.layers = ansatz, n, layers
        self.local = n - self.k
        self.piece = PIECE if D > 1 else 0
        self.ents = [entangler_gates(ansatz, n, layer, edges) for layer in range(layers)]

    # -- where a qubit lives ---------------------------------------------------

    def _block_bit(self, q: int) -> int:
        return 1 << (self.k - 1 - q)

    def _pairs(self, q: int):
        """(b0, b1) over the block pairs that differ in block bit q."""
        bit = self._block_bit(q)
        return [(b, b | bit) for b in range(len(self.devices)) if not b & bit]

    def halves(self, blocks: List[torch.Tensor], q: int):
        """[(half with qubit q = 0, half with q = 1)] over blocks or pairs."""
        if q < self.k:
            return [(blocks[b0], blocks[b1]) for b0, b1 in self._pairs(q)]
        p = q - self.k
        return [(fix_bits(x, self.local, {p: 0}), fix_bits(x, self.local, {p: 1}))
                for x in blocks]

    # -- gates -------------------------------------------------------------------

    def apply_1q(self, blocks: List[torch.Tensor], U, q: int) -> None:
        """The 2x2 operator U (complex numbers) on qubit q, in place."""
        for a, b in self.halves(blocks, q):
            _rotate(a, b, U, self.piece)

    def cnot(self, blocks: List[torch.Tensor], c: int, t: int) -> None:
        k, nl = self.k, self.local
        if t >= k:
            for b, x in enumerate(blocks):
                if c < k:
                    if b & self._block_bit(c):
                        _swap(fix_bits(x, nl, {t - k: 0}), fix_bits(x, nl, {t - k: 1}), self.piece)
                else:
                    _swap(fix_bits(x, nl, {c - k: 1, t - k: 0}),
                          fix_bits(x, nl, {c - k: 1, t - k: 1}), self.piece)
            return
        for b0, b1 in self._pairs(t):
            if c < k:
                if b0 & self._block_bit(c):
                    _swap(blocks[b0], blocks[b1], self.piece)
            else:
                _swap(fix_bits(blocks[b0], nl, {c - k: 1}), fix_bits(blocks[b1], nl, {c - k: 1}),
                      self.piece)

    def cz(self, blocks: List[torch.Tensor], a: int, b: int) -> None:
        k = self.k
        for i, x in enumerate(blocks):
            if any(q < k and not i & self._block_bit(q) for q in (a, b)):
                continue
            fix_bits(x, self.local, {q - k: 1 for q in (a, b) if q >= k}).neg_()

    def entangle(self, blocks: List[torch.Tensor], layer: int, inverse: bool = False) -> None:
        cnots, czs = self.ents[layer]
        if inverse:
            for a, b in czs:
                self.cz(blocks, a, b)
            for c, t in reversed(cnots):
                self.cnot(blocks, c, t)
            return
        for c, t in cnots:
            self.cnot(blocks, c, t)
        for a, b in czs:
            self.cz(blocks, a, b)

    # -- the circuit ---------------------------------------------------------------

    def state(self, theta: np.ndarray) -> List[torch.Tensor]:
        """psi(theta) as its blocks, each (2^(n-k),) complex128."""
        U, _ = rotations(np.asarray(theta).reshape(self.layers, self.n, 3))
        psi = [torch.full((1 << self.local,), 2.0 ** (-0.5 * self.n), dtype=torch.complex128,
                          device=d) for d in self.devices]
        for layer in range(self.layers):
            for q in range(self.n):
                self.apply_1q(psi, U[layer, q].tolist(), q)
            self.entangle(psi, layer)
        return psi

    def probs(self, theta: np.ndarray) -> List[torch.Tensor]:
        """|psi(theta)|^2 as its blocks, each (2^(n-k),) float64."""
        return [x.real ** 2 + x.imag ** 2 for x in self.state(theta)]

    def grad(self, theta: np.ndarray, g: List[torch.Tensor],
             psi: List[torch.Tensor] = None) -> np.ndarray:
        """dL/dtheta (L*n*3,) float64 for a loss L(q) with dL/dq = g (its
        blocks, taken out of the list as the cotangent replaces them), by
        the adjoint sweep from the final state psi (recomputed when not
        given; un-computed in place when given)."""
        L, n = self.layers, self.n
        U, dU = rotations(np.asarray(theta).reshape(L, n, 3))
        Uh = np.conj(np.swapaxes(U, -1, -2))
        psi = self.state(theta) if psi is None else psi
        lam = [g.pop(0).to(torch.float64) * pb for pb in psi]
        inner = {}
        for layer in reversed(range(L)):
            self.entangle(psi, layer, inverse=True)
            self.entangle(lam, layer, inverse=True)
            for q in reversed(range(n)):
                self.apply_1q(psi, Uh[layer, q].tolist(), q)
                hl, hp = self.halves(lam, q), self.halves(psi, q)
                inner[layer, q] = [[[_inner(l[a], p[b], self.piece) for l, p in zip(hl, hp)]
                                    for b in range(2)] for a in range(2)]
                self.apply_1q(lam, Uh[layer, q].tolist(), q)
        out = np.zeros((L, n, 3))
        for (layer, q), parts in inner.items():
            M = np.array([[sum(complex(v) for v in parts[a][b]) for b in range(2)]
                          for a in range(2)])
            out[layer, q] = 2.0 * np.real((dU[layer, q] * M).sum(axis=(-2, -1)))
        return out.reshape(-1)
