"""Two-sided Kronecker apply of the Stein columns: kernels 3 and 4 of the port.

Replaces ``tensornetworks_tpu/ops/pallas/stein2d.py``
(``make_pallas_stein2d_matvec`` → ``kernel``, and its large-n tiling
``make_pallas_stein2d_matvec_grid`` → ``kernel``) with ``csrc/stein2d.cu``:
``Y_i = Ar V_i Acᵀ`` for all 3n+1 column blocks, through the batched FP32
GEMM shared with the circuit kernels.

- ``stein2d_apply`` (n ≤ 17): all blocks in one batch, two launches. Bound
  at n=16 (49 blocks of 256x256): 3.29 GFLOP of FP32 FMA, 49 µs at the
  H100's 67 TFLOP/s; 25.9 MB moved, 7.7 µs at 3.35 TB/s. The intermediate
  ``Ar V_i`` (12.8 MB) stays in L2 between the two launches.
- ``stein2d_apply_grid`` (n ≥ 18): the blocks in chunks of ``grid_chunk``,
  two launches per chunk, so that the intermediate of a chunk stays in L2
  and the scratch is O(chunk) (one batch at n=20 would need a 256 MB
  intermediate). Bound at n=20 (61 blocks of 1024x1024): 2.6e11 FLOP,
  3.91 ms at 67 TFLOP/s; 520 MB moved, 0.16 ms at 3.35 TB/s.

Both compute the same function; their plain version is
``stein2d_apply_plain``. The V build and the closed-form recombination stay
in plain torch (``ops/stein.py``), as they stay in XLA around the TPU
kernels. A wrapper takes the plain version only for CPU tensors; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _lib

# A chunk's intermediate Ar·V_i: 24 MB, about half of the H100's 50 MB L2
# (6 blocks of 4 MB at n=20).
GRID_CHUNK_BYTES = 24 << 20


def stein2d_apply_plain(Ar: torch.Tensor, Ac: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """(cols, R, C) -> (cols, R, C): ``Ar @ V_i @ Acᵀ`` per block."""
    return torch.matmul(torch.matmul(Ar, V), Ac.T)


def grid_chunk(R: int, C: int, cols: int) -> int:
    """Blocks per chunk of ``stein2d_apply_grid``: as many (R, C) float32
    intermediates as fit in ``GRID_CHUNK_BYTES``, at least one."""
    return max(1, min(cols, GRID_CHUNK_BYTES // (4 * R * C)))


def _check(Ar, Ac, V) -> None:
    cols, R, C = V.shape
    for name, t, shape in (("Ar", Ar, (R, R)), ("Ac", Ac, (C, C)), ("V", V, (cols, R, C))):
        if t.device != V.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"stein2d kernel: {name} must be a contiguous float32 tensor "
                             f"on {V.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"stein2d kernel: {name} has shape {tuple(t.shape)}, want {shape}")


def stein2d_apply(Ar: torch.Tensor, Ac: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """``Ar @ V_i @ Acᵀ`` for every block of ``V`` (cols, R, C), in one batch."""
    if V.device.type == "cpu":
        return stein2d_apply_plain(Ar, Ac, V)
    _check(Ar, Ac, V)
    cols, R, C = V.shape
    fn = _lib.load("stein2d").tn_stein2d_apply
    Y = torch.empty_like(V)
    tmp = torch.empty_like(V)
    _lib.count_launch("stein2d")
    err = fn(_lib.ptr(Ar), _lib.ptr(Ac), _lib.ptr(V), _lib.ptr(Y), _lib.ptr(tmp),
             R, C, cols, _lib.stream_ptr(V.device))
    _lib.check(err, "tn_stein2d_apply")
    return Y


def stein2d_apply_grid(Ar: torch.Tensor, Ac: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """``Ar @ V_i @ Acᵀ`` for every block of ``V`` (cols, R, C), in chunks of
    ``grid_chunk(R, C, cols)`` blocks."""
    if V.device.type == "cpu":
        return stein2d_apply_plain(Ar, Ac, V)
    _check(Ar, Ac, V)
    cols, R, C = V.shape
    chunk = grid_chunk(R, C, cols)
    fn = _lib.load("stein2d").tn_stein2d_apply_grid
    Y = torch.empty_like(V)
    tmp = torch.empty((chunk, R, C), dtype=V.dtype, device=V.device)
    _lib.count_launch("stein2d_grid")
    err = fn(_lib.ptr(Ar), _lib.ptr(Ac), _lib.ptr(V), _lib.ptr(Y), _lib.ptr(tmp),
             R, C, cols, chunk, _lib.stream_ptr(V.device))
    _lib.check(err, "tn_stein2d_apply_grid")
    return Y
