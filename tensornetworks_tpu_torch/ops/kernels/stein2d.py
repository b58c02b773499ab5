"""Two-sided Kronecker apply of the Stein columns: kernel 3 of the port.

Replaces ``tensornetworks_tpu/ops/pallas/stein2d.py``
(``make_pallas_stein2d_matvec`` → ``kernel``) with ``csrc/stein2d.cu``:
``Y_i = Ar V_i Acᵀ`` for all 3n+1 column blocks, as two launches of the
batched FP32 GEMM shared with the circuit kernels.

- Bound at n=16 (49 blocks of 256x256): 3.29 GFLOP of FP32 FMA, 49 µs at
  the H100's 67 TFLOP/s; 25.9 MB moved, 7.7 µs at 3.35 TB/s.
- The batch of 49 gives 784 blocks of 64x64 outputs, enough to fill the
  card; the intermediate ``Ar V_i`` stays in L2 between the two launches.

The V build and the closed-form recombination stay in plain torch
(``ops/stein.py``), as they stay in XLA around the TPU kernel. The wrapper
takes the plain version only for CPU tensors; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from . import _lib


def stein2d_apply_plain(Ar: torch.Tensor, Ac: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """(cols, R, C) -> (cols, R, C): ``Ar @ V_i @ Acᵀ`` per block."""
    return torch.matmul(torch.matmul(Ar, V), Ac.T)


def stein2d_apply(Ar: torch.Tensor, Ac: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """``Ar @ V_i @ Acᵀ`` for every block of ``V`` (cols, R, C)."""
    if V.device.type == "cpu":
        return stein2d_apply_plain(Ar, Ac, V)
    cols, R, C = V.shape
    for name, t, shape in (("Ar", Ar, (R, R)), ("Ac", Ac, (C, C)), ("V", V, (cols, R, C))):
        if t.device != V.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"stein2d kernel: {name} must be a contiguous float32 tensor "
                             f"on {V.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"stein2d kernel: {name} has shape {tuple(t.shape)}, want {shape}")
    fn = _lib.load("stein2d").tn_stein2d_apply
    Y = torch.empty_like(V)
    tmp = torch.empty_like(V)
    _lib.count_launch("stein2d")
    err = fn(_lib.ptr(Ar), _lib.ptr(Ac), _lib.ptr(V), _lib.ptr(Y), _lib.ptr(tmp),
             R, C, cols, _lib.stream_ptr(V.device))
    _lib.check(err, "tn_stein2d_apply")
    return Y
