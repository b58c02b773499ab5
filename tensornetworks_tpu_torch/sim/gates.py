"""Quantum gate builders: batched single-qubit rotations and Kronecker folds.

Counterpart of ``tensornetworks_tpu/sim/gates.py``. Angles are real tensors;
the matrices are complex (``complex64`` for float32 angles, ``complex128``
for float64), with the MSB-first wire convention of ``core.bits``. The θ →
operator folds (``layer_rotations``, ``rotation_operators``) each record
one ``born.fold`` span (``train.span``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..train import span

H = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2.0)
X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
Z = np.array([[1, 0], [0, -1]], dtype=np.complex128)


def _mat2(a00, a01, a10, a11) -> torch.Tensor:
    """Assemble (..., 2, 2) from four broadcastable entries."""
    return torch.stack(
        [torch.stack([a00, a01], dim=-1), torch.stack([a10, a11], dim=-1)], dim=-2
    )


def rx_batched(theta: torch.Tensor) -> torch.Tensor:
    """RX(θ) = exp(-i θ X / 2) over an array of angles -> (..., 2, 2)."""
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    z = torch.zeros_like(c)
    cc, ms = torch.complex(c, z), torch.complex(z, -s)
    return _mat2(cc, ms, ms, cc)


def ry_batched(theta: torch.Tensor) -> torch.Tensor:
    """RY(θ) = exp(-i θ Y / 2)."""
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    z = torch.zeros_like(c)
    return _mat2(torch.complex(c, z), torch.complex(-s, z), torch.complex(s, z),
                 torch.complex(c, z))


def rz_batched(theta: torch.Tensor) -> torch.Tensor:
    """RZ(θ) = exp(-i θ Z / 2)."""
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    zero = torch.complex(torch.zeros_like(c), torch.zeros_like(c))
    return _mat2(torch.complex(c, -s), zero, zero, torch.complex(c, s))


def rot_zyx_batched(ax, ay, az) -> torch.Tensor:
    """Fused RZ(az)·RY(ay)·RX(ax): a circuit applying RX, then RY, then RZ."""
    return rz_batched(az) @ ry_batched(ay) @ rx_batched(ax)


def rot_zy_batched(ay, az) -> torch.Tensor:
    """Fused RZ(az)·RY(ay) for the 'basic' ansatz (RY then RZ)."""
    return rz_batched(az) @ ry_batched(ay)


def batched_kron(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Kronecker product over the trailing two axes, batched over the rest."""
    da, db = A.shape[-1], B.shape[-1]
    out = torch.einsum("...ij,...kl->...ikjl", A, B)
    return out.reshape(*A.shape[:-2], da * db, da * db)


def kron_fold(mats) -> torch.Tensor:
    """Balanced-tree Kronecker fold of a sequence of ``(..., d, d)`` operators
    (the same operator as the left-to-right chain, in log depth)."""
    mats = list(mats)
    if not mats:
        raise ValueError("kron_fold of an empty sequence")
    while len(mats) > 1:
        nxt = [batched_kron(mats[i], mats[i + 1]) for i in range(0, len(mats) - 1, 2)]
        if len(mats) % 2:
            nxt.append(mats[-1])
        mats = nxt
    return mats[0]


def _layer_rotations(params: torch.Tensor, num_wires: int, layers: int,
                     per_qubit: int) -> torch.Tensor:
    angles = params.reshape(layers, num_wires, per_qubit)
    if per_qubit == 3:
        return rot_zyx_batched(angles[..., 0], angles[..., 1], angles[..., 2])
    return rot_zy_batched(angles[..., 0], angles[..., 1])


def layer_rotations(params: torch.Tensor, num_wires: int, layers: int,
                    per_qubit: int) -> torch.Tensor:
    """(L, n, 2, 2) fused per-qubit rotations of a parameter vector laid out
    as (layer, qubit, angle)."""
    with span("born.fold"):
        return _layer_rotations(params, num_wires, layers, per_qubit)


def rotation_operators(params: torch.Tensor, num_wires: int, layers: int,
                       per_qubit: int) -> tuple:
    """Per-layer row and column operators of the 2D super-block view:
    ``Mr`` (L, R, R) folds qubits 0..rb-1, ``Mc`` (L, C, C) the rest."""
    with span("born.fold"):
        U = _layer_rotations(params, num_wires, layers, per_qubit)
        rb = (num_wires + 1) // 2
        return (kron_fold([U[:, q] for q in range(rb)]),
                kron_fold([U[:, q] for q in range(rb, num_wires)]))


def wall_operators(embed_angles: torch.Tensor, num_wires: int) -> tuple:
    """The conditioning wall RY(angles) on every qubit as row and column
    operators of the 2D view: ``Er`` (..., R, R) folds qubits 0..rb-1, ``Ec``
    (..., C, C) the rest. ``embed_angles`` is (n,) for one wall or (L, n)
    for one wall per layer."""
    E = ry_batched(embed_angles)
    rb = (num_wires + 1) // 2
    return (kron_fold([E[..., q, :, :] for q in range(rb)]),
            kron_fold([E[..., q, :, :] for q in range(rb, num_wires)]))


def fold_wall(Mr: torch.Tensor, Mc: torch.Tensor, embed_angles: torch.Tensor,
              num_wires: int, reupload: bool) -> tuple:
    """Per-layer operators (L, R, R), (L, C, C) with the conditioning wall
    folded in before the rotations: ``X ← Mr (Er X Ecᵀ) Mcᵀ = (Mr Er) X
    (Mc Ec)ᵀ``. A single wall (``reupload=False``) goes into layer 0 only;
    re-uploading puts it before every layer, one wall for all layers from
    (n,) angles or wall l before layer l from (L, n) angles."""
    if embed_angles.dim() == 2 and not reupload:
        raise ValueError("per-layer embed_angles require reupload=True")
    Er, Ec = wall_operators(embed_angles.to(Mr.real.dtype), num_wires)
    if reupload:
        return Mr @ Er, Mc @ Ec
    return (torch.cat([(Mr[0] @ Er)[None], Mr[1:]]),
            torch.cat([(Mc[0] @ Ec)[None], Mc[1:]]))


def fold_wall_gates(U: torch.Tensor, embed_angles: torch.Tensor, reupload: bool) -> torch.Tensor:
    """Per-layer gates (L, n, 2, 2) with the conditioning wall RY(angles)
    folded in per qubit before the rotations, ``U[l, q] @ E[q]``: into
    layer 0 for a single wall (``reupload=False``), into every layer when
    re-uploading, one wall for all layers from (n,) angles or wall l before
    layer l from (L, n) angles. The gate form of ``fold_wall``."""
    if embed_angles.dim() == 2 and not reupload:
        raise ValueError("per-layer embed_angles require reupload=True")
    E = ry_batched(embed_angles.to(U.real.dtype))
    if reupload:
        return U @ E
    return torch.cat([(U[0] @ E)[None], U[1:]])
