"""The DAG-structured ansatz (``bn_structured``): entanglers follow a
Bayesian network's latent edges instead of a hardware chain.

Counterpart of ``latent_edges`` and ``make_structured_probs_fn`` in
``tensornetworks_tpu/sim/structured.py``. A layer ℓ is
RZ·RY·RX on every qubit (the ``hardware_efficient`` layout, 3·L·n
parameters), after the uniform start (the Hadamard wall), then along every
edge (parent, child), in the order given: CNOT(parent → child) on even
layers, CZ(parent, child) on odd layers. With ``conditioning=True`` the
function takes ``(params, embed_angles)`` and puts one RY(angles[q]) wall
after the Hadamard wall, as the JAX oracle does; re-uploading the wall
before every layer is the circuit kernels' (``ops/kernels``), held against
the JAX package's structured executors in the tests.

``make_structured_probs_fn`` is the 2D flip-select form in plain torch
(per-edge masked flips of the (R, C) super-block view), differentiated by
autograd. It is the port's oracle for this ansatz and its ``structured2d``
backend. It shares no code with the circuit kernels' path: it builds each
2×2 rotation here from the gate definitions and applies it to its qubit's
axis of the state, where the kernels' path folds the rotations into the
Kronecker operators Mr/Mc (``sim/gates.rotation_operators``), and it flips
along each edge, where the kernels apply one GF(2) index map per layer
(``ops/kernels/circuit2d.layer_masks``). Holding one against the other is a
real check of both the θ → operator fold and the maps. The JAX package's flat,
composed and block-composed executors are TPU layout strategies of the same
function and are not ported.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch



def check_edges(num_wires: int, edges) -> List[Tuple[int, int]]:
    """``edges`` as a list of int pairs, each with both ends on a wire and
    control ≠ target (the JAX module's check); the order is kept, since
    CNOTs do not commute."""
    edges = [(int(c), int(t)) for c, t in edges]
    for c, t in edges:
        if not (0 <= c < num_wires and 0 <= t < num_wires) or c == t:
            raise ValueError(f"bad edge ({c}, {t}) for {num_wires} wires")
    return edges


def latent_edges(bn, latent_names: Sequence[str]) -> List[Tuple[int, int]]:
    """(parent_qubit, child_qubit) pairs for every BN edge whose endpoints
    are both latent, with qubit index = position in ``latent_names``."""
    pos = {v: i for i, v in enumerate(latent_names)}
    edges = []
    for v in latent_names:
        for p in bn.parents[v]:
            if p in pos:
                edges.append((pos[p], pos[v]))
    return edges


def _rotations(params: torch.Tensor, num_wires: int, layers: int) -> torch.Tensor:
    """(L, n, 2, 2) RZ(az)·RY(ay)·RX(ax) of params laid out (layer, qubit,
    (ax, ay, az)), from RX(a) = [[c, −is], [−is, c]], RY(a) = [[c, −s],
    [s, c]], RZ(a) = diag(e^(−ia/2), e^(ia/2)), with c, s = cos, sin(a/2)."""
    half = params.reshape(layers, num_wires, 3) / 2
    c, s = torch.cos(half), torch.sin(half)
    cdtype = torch.complex128 if params.dtype == torch.float64 else torch.complex64
    c, s = c.to(cdtype), s.to(cdtype)
    zero = torch.zeros_like(c[..., 0])

    def mat(a, b, d, e):
        return torch.stack([torch.stack([a, b], -1), torch.stack([d, e], -1)], -2)

    rx = mat(c[..., 0], -1j * s[..., 0], -1j * s[..., 0], c[..., 0])
    ry = mat(c[..., 1], -s[..., 1], s[..., 1], c[..., 1])
    rz = mat(c[..., 2] - 1j * s[..., 2], zero, zero, c[..., 2] + 1j * s[..., 2])
    return rz @ ry @ rx


def make_structured_probs_fn(num_wires: int, layers: int, edges, conditioning: bool = False):
    """probs(params) -> (2^n,) of the DAG-structured ansatz; params (3·L·n,)
    laid out (layer, qubit, angle). Complex128 for float64 params, complex64
    for float32. ``conditioning``: probs(params, embed_angles), the (n,) RY
    wall applied qubit by qubit after the Hadamard wall."""
    n = num_wires
    rb = (n + 1) // 2
    cb = n - rb
    R, C = 1 << rb, 1 << cb
    edges = check_edges(n, edges)

    def bit_mask(q, dtype, device):
        """0/1 indicator of qubit q's basis bit, (R, 1) for a row qubit,
        (1, C) for a column qubit."""
        if q < rb:
            b = (torch.arange(R, device=device) >> (rb - 1 - q)) & 1
            return b.to(dtype)[:, None]
        b = (torch.arange(C, device=device) >> (cb - 1 - (q - rb))) & 1
        return b.to(dtype)[None, :]

    def qubit_view(X, q):
        """X with qubit q's basis bit as axis 1 of a 4-axis view."""
        if q < rb:
            pre = 1 << q
            return X.reshape(pre, 2, R // (2 * pre), C)
        pre = 1 << (q - rb)
        return X.reshape(R * pre, 2, C // (2 * pre), 1)

    def flip_bit(X, q):
        """Reverse qubit q's basis bit: reshape and flip one axis."""
        return qubit_view(X, q).flip(1).reshape(R, C)

    def rotate(X, U, q):
        """The 2×2 operator U on qubit q."""
        return torch.einsum("ab,pbqc->paqc", U, qubit_view(X, q)).reshape(R, C)

    def probs(params: torch.Tensor, embed_angles=None) -> torch.Tensor:
        U = _rotations(params, n, layers)
        real, dev = params.dtype, params.device
        X = torch.full((R, C), 2.0 ** (-0.5 * n), dtype=U.dtype, device=dev)
        if conditioning:
            if embed_angles is None:
                raise ValueError("conditioning=True requires embed_angles")
            half = embed_angles.reshape(n).to(real) / 2
            c, s = torch.cos(half).to(U.dtype), torch.sin(half).to(U.dtype)
            for q in range(n):  # RY(a) = [[c, -s], [s, c]]
                X = rotate(X, torch.stack([torch.stack([c[q], -s[q]]),
                                           torch.stack([s[q], c[q]])]), q)
        # All of an odd layer's CZ signs in one mask (CZs are diagonal, so
        # they commute); a pair listed twice cancels, as two CZs do.
        sign = torch.ones((1, 1), dtype=real, device=dev)
        for c, t in edges:
            sign = sign * (1.0 - 2.0 * bit_mask(c, real, dev) * bit_mask(t, real, dev))
        for layer in range(layers):
            for q in range(n):
                X = rotate(X, U[layer, q], q)
            if not edges:
                continue
            if layer % 2 == 0:
                for c, t in edges:
                    X = X + bit_mask(c, real, dev) * (flip_bit(X, t) - X)
            else:
                X = X * sign
        flat = X.reshape(-1)
        return flat.real ** 2 + flat.imag ** 2

    return probs
