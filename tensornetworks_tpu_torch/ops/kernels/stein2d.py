"""Kronecker apply of the Stein columns: kernels 3 and 4 of the port.

Replaces ``tensornetworks_tpu/ops/pallas/stein2d.py``
(``make_pallas_stein2d_matvec`` → ``kernel``, and its large-n tiling
``make_pallas_stein2d_matvec_grid`` → ``kernel``) with ``csrc/stein2d.cu``:
``Y_i = Ar V_i Acᵀ`` for all 3n+1 column blocks, ``Ar = A^{⊗rb}``,
``Ac = A^{⊗cb}``, ``A = [[1, a], [a, 1]]``. On the flat MSB-first index that
is ``y_i = A^{⊗n} v_i``, a function fixed by ``a`` (the decay factor of
``(num_vars, length_scale)``) and n.

- ``stein2d_apply`` (1 ≤ n ≤ 17): one launch, one pass through memory.
  A thread block holds a tile of ``2^CLUSTER_TILE_BITS`` floats (64 KB) and
  applies the stages of its local bits; up to n = 14 a tile holds whole
  columns, above it a thread block cluster of ``2^(n-14)`` blocks holds a
  column and each block finishes the high stages for its slice of the
  local indices, reading every tile of the cluster through distributed
  shared memory. At n=16 (49 columns) the least work is 25.7 MB moved, 7.7
  µs at 3.35 TB/s; the TPU kernel's dense split is 3.29 GFLOP, 49 µs at
  67 TFLOP/s.
- ``stein2d_apply_grid`` (n ≥ 18): two passes per chunk of ``grid_chunk``
  blocks, each block of the launch holding a tile of ``2^GRID_TILE_BITS``
  floats in shared memory: pass 1 the low ``GRID_TILE_BITS`` bits on
  contiguous tiles, pass 2 the high bits on strided tiles, in place; the
  chunk stays in L2 between them. At n=20 (61 blocks of 2^20) V read once
  and Y written once is 512 MB, 0.153 ms at 3.35 TB/s, against the dense
  split's 2.6e11 FLOP, 3.91 ms.

Both are Kronecker butterflies: ``A^{⊗n}`` is n commuting stages
``y[j] = x[j] + a·x[j ^ 2^k]``, one FMA per element and stage, so the work
is bytes. Their plain version is the dense ``stein2d_apply_plain`` (cuBLAS on
the card), a different algorithm from the butterflies.
``stein2d_cluster_plain`` and ``stein2d_butterfly_plain`` mirror the two
kernels' tile arithmetic in torch so that the CPU tests pin their index
maps; nothing on the main path calls them. The V build and the closed-form recombination stay in
plain torch (``ops/stein.py``), as they stay in XLA around the TPU kernels.
A wrapper takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kron import kron_power_np
from . import _lib

# A chunk of column blocks between the butterfly's two passes: 24 MB, about
# half of the H100's 50 MB L2 (6 blocks of 4 MB at n=20).
GRID_CHUNK_BYTES = 24 << 20
# log2 of the floats a thread block holds in shared memory (csrc/stein2d.cu
# kTileBits): 32 KB.
GRID_TILE_BITS = 13
# The same for stein2d_apply (kClusterTileBits): 64 KB; and the largest
# cluster, 2^3 blocks (kMaxClusterBits, the portable limit).
CLUSTER_TILE_BITS, MAX_CLUSTER_BITS = 14, 3


def stein2d_apply_plain(Ar: torch.Tensor, Ac: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """(cols, R, C) -> (cols, R, C): ``Ar @ V_i @ Acᵀ`` per block."""
    return torch.matmul(torch.matmul(Ar, V), Ac.T)


def kron_factors(a: float, R: int, C: int, dtype=torch.float32, device="cpu"):
    """``(A^{⊗log2 R}, A^{⊗log2 C})`` of ``A = [[1, a], [a, 1]]``, built in
    float64 and cast to ``dtype``."""
    A = np.array([[1.0, a], [a, 1.0]])
    return tuple(torch.as_tensor(kron_power_np(A, s.bit_length() - 1), dtype=dtype, device=device)
                 for s in (R, C))


def _stage(X: torch.Tensor, k: int, a: float) -> torch.Tensor:
    """The stage of local bit k on the last axis: x[t] + a·x[t ^ 2^k]."""
    shape = X.shape
    X = X.reshape(*shape[:-1], -1, 2, 1 << k)
    x0, x1 = X[..., 0, :], X[..., 1, :]
    return torch.stack([x0 + a * x1, x1 + a * x0], dim=-2).reshape(shape)


def _tile_offsets(n: int, tile_bits: int, lw: int) -> torch.Tensor:
    """(2^(n-T), 2^T): the offset in a column block of local index t of tile
    ``sub``, as the kernel computes it: sub·2^lw + (t >> lw)·2^T + (t & (2^lw-1))."""
    t = torch.arange(1 << tile_bits)
    sub = torch.arange(1 << (n - tile_bits))
    return (sub[:, None] << lw) + ((t >> lw) << tile_bits) + (t & ((1 << lw) - 1))


def stein2d_butterfly_plain(a: float, V: torch.Tensor,
                            tile_bits: int = GRID_TILE_BITS) -> torch.Tensor:
    """(cols, R, C) -> (cols, R, C): ``stein2d_apply_grid``'s butterfly in
    torch, tile by tile as its two passes group it. Pass 1 applies local bits
    0..T-1 of contiguous tiles of 2^T; pass 2 the h = n - T high bits, on
    tiles of 2^h values of the high bits times a run of 2^(T-h) contiguous low
    indices. Needs 0 < n - T ≤ T."""
    cols, R, C = V.shape
    n = (R * C).bit_length() - 1
    high = n - tile_bits
    if not 0 < high <= tile_bits:
        raise ValueError(f"stein2d butterfly: n={n} needs 0 < n - tile_bits <= tile_bits "
                         f"(tile_bits={tile_bits})")
    Y = V.reshape(cols, -1).clone()
    for lw, k_lo in ((tile_bits, 0), (tile_bits - high, tile_bits - high)):
        idx = _tile_offsets(n, tile_bits, lw).to(V.device)
        X = Y[:, idx]  # (cols, subs, 2^T)
        for k in range(k_lo, tile_bits):
            X = _stage(X, k, a)
        Y[:, idx] = X
    return Y.reshape(cols, R, C)


def stein2d_cluster_plain(a: float, V: torch.Tensor,
                          tile_bits: int = CLUSTER_TILE_BITS) -> torch.Tensor:
    """(cols, R, C) -> (cols, R, C): ``stein2d_apply``'s cluster butterfly in
    torch, split as the kernel splits it. The flat blocks are cut into
    contiguous tiles of 2^T (the last one padded with zeros), and each tile
    gets the stages of local bits 0..min(n, T)-1. For h = n - T > 0 a column
    is the 2^h tiles of one cluster, and rank r takes slice r of the local
    indices (2^(T-h) of them) from every tile, applies the h high stages and
    writes all 2^h outputs. Needs n ≤ T + ``MAX_CLUSTER_BITS``."""
    cols, R, C = V.shape
    n = (R * C).bit_length() - 1
    h = max(0, n - tile_bits)
    if h > MAX_CLUSTER_BITS:
        raise ValueError(f"stein2d cluster butterfly: n={n} needs n - tile_bits <= "
                         f"{MAX_CLUSTER_BITS} (tile_bits={tile_bits})")
    flat = V.reshape(-1)
    tiles = -(-flat.numel() // (1 << tile_bits))
    X = torch.zeros(tiles << tile_bits, dtype=V.dtype, device=V.device)
    X[:flat.numel()] = flat
    X = X.reshape(tiles, 1 << tile_bits)
    for k in range(min(n, tile_bits)):
        X = _stage(X, k, a)
    if h == 0:
        return X.reshape(-1)[:flat.numel()].reshape(V.shape)
    X = X.reshape(cols, 1 << h, 1 << tile_bits)  # (column, cluster rank's tile, local index)
    Y = torch.empty_like(X)
    width = 1 << (tile_bits - h)
    for rank in range(1 << h):
        part = X[:, :, rank * width:(rank + 1) * width].transpose(1, 2)  # (cols, slice, tiles)
        for s in range(h):
            part = _stage(part, s, a)
        Y[:, :, rank * width:(rank + 1) * width] = part.transpose(1, 2)
    return Y.reshape(V.shape)


def grid_chunk(R: int, C: int, cols: int) -> int:
    """Blocks per chunk of ``stein2d_apply_grid``: as many (R, C) float32
    blocks as fit in ``GRID_CHUNK_BYTES``, at least one."""
    return max(1, min(cols, GRID_CHUNK_BYTES // (4 * R * C)))


def _check_operand(name: str, t: torch.Tensor, device, shape) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"stein2d kernel: {name} must be a contiguous float32 tensor "
                         f"on {device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"stein2d kernel: {name} has shape {tuple(t.shape)}, want {shape}")


def _check_cluster(V) -> int:
    """n of a (cols, R, C) operand the cluster kernel takes."""
    if V.dim() != 3:
        raise ValueError(f"stein2d_apply: V must be (cols, R, C), got shape {tuple(V.shape)}")
    _check_operand("V", V, V.device, tuple(V.shape))
    _, R, C = V.shape
    n = (R * C).bit_length() - 1
    if R & (R - 1) or C & (C - 1) or not 1 <= n <= CLUSTER_TILE_BITS + MAX_CLUSTER_BITS:
        raise ValueError(f"stein2d_apply: R, C must be powers of two with "
                         f"1 <= log2(R·C) <= {CLUSTER_TILE_BITS + MAX_CLUSTER_BITS}, "
                         f"got R={R}, C={C}")
    if V.data_ptr() % 16:
        raise ValueError("stein2d_apply: V must be 16-byte aligned")
    return n


def _check_grid(V) -> int:
    """n of a (cols, R, C) operand the butterfly kernel takes."""
    if V.dim() != 3:
        raise ValueError(f"stein2d_apply_grid: V must be (cols, R, C), got shape {tuple(V.shape)}")
    _check_operand("V", V, V.device, tuple(V.shape))
    _, R, C = V.shape
    n = (R * C).bit_length() - 1
    if R & (R - 1) or C & (C - 1) or not GRID_TILE_BITS < n <= 2 * GRID_TILE_BITS - 2:
        raise ValueError(f"stein2d_apply_grid: R, C must be powers of two with "
                         f"{GRID_TILE_BITS} < log2(R·C) <= {2 * GRID_TILE_BITS - 2}, "
                         f"got R={R}, C={C}")
    return n


def stein2d_apply(a: float, V: torch.Tensor) -> torch.Tensor:
    """``A^{⊗n}`` applied to every flat block of ``V`` (cols, R, C), i.e.
    ``Ar @ V_i @ Acᵀ`` with ``A = [[1, a], [a, 1]]``: the cluster butterfly
    kernel in one launch, which raises if the card cannot place its
    clusters."""
    if V.device.type == "cpu":
        _, R, C = V.shape
        return stein2d_apply_plain(*kron_factors(a, R, C, V.dtype), V)
    n = _check_cluster(V)
    fn = _lib.load("stein2d").tn_stein2d_apply
    Y = torch.empty_like(V)
    _lib.count_launch("stein2d")
    err = fn(_lib.ptr(V), _lib.ptr(Y), ctypes.c_float(a), n, V.shape[0],
             _lib.stream_ptr(V.device))
    _lib.check(err, "tn_stein2d_apply (cluster launch)")
    return Y


def stein2d_apply_grid(a: float, V: torch.Tensor) -> torch.Tensor:
    """``A^{⊗n}`` applied to every flat block of ``V`` (cols, R, C), i.e.
    ``Ar @ V_i @ Acᵀ`` with ``A = [[1, a], [a, 1]]``: the butterfly kernel
    in chunks of ``grid_chunk(R, C, cols)`` blocks."""
    if V.device.type == "cpu":
        _, R, C = V.shape
        return stein2d_apply_plain(*kron_factors(a, R, C, V.dtype), V)
    n = _check_grid(V)
    cols, R, C = V.shape
    fn = _lib.load("stein2d").tn_stein2d_apply_grid
    Y = torch.empty_like(V)
    _lib.count_launch("stein2d_grid")
    err = fn(_lib.ptr(V), _lib.ptr(Y), ctypes.c_float(a), n, cols, grid_chunk(R, C, cols),
             _lib.stream_ptr(V.device))
    _lib.check(err, "tn_stein2d_apply_grid")
    return Y
