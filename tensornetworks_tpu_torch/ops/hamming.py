"""Hamming base kernel over {0,1}^n, in closed form.

Counterpart of ``tensornetworks_tpu/ops/hamming.py``. With
``a = exp(-1/(n*l))`` the kernel between two states is ``a^d`` for Hamming
distance ``d``; over all ``2^n`` states it is the Kronecker power
``A^{⊗n}``, ``A = [[1, a], [a, 1]]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bits import all_bitstrings


def resolve_length_scale(length_scale, num_vars: int) -> float:
    """Resolve a length-scale spec to a float.

    ``"auto"`` is the measured per-n bandwidth optimum of the JAX package:
    ``1/n`` up to 17 variables (one kernel e-fold per flipped bit) and
    ``2/n`` from 18. Numeric values pass through unchanged.
    """
    if isinstance(length_scale, str):
        if length_scale != "auto":
            raise ValueError(
                f"length_scale must be a float or 'auto', got {length_scale!r}")
        n = max(num_vars, 1)
        return (2.0 if n >= 18 else 1.0) / n
    return float(length_scale)


def decay_factor(num_vars: int, length_scale: float = 1.0) -> float:
    """a = exp(-1 / (n * length_scale)) — per-flipped-bit kernel decay."""
    if num_vars == 0:
        return 1.0
    return float(np.exp(-1.0 / (num_vars * length_scale)))


def hamming_distance(z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
    """L1 distance of bit vectors along the last axis (batched, broadcast)."""
    return (z1 - z2).abs().sum(dim=-1)


def base_hamming_kernel(z1: torch.Tensor, z2: torch.Tensor, num_vars: int,
                        length_scale: float = 1.0) -> torch.Tensor:
    """``exp(-d/(n·l))`` between (batched) bit vectors; 1 for n = 0."""
    if num_vars == 0:
        shape = torch.broadcast_shapes(z1.shape[:-1], z2.shape[:-1])
        return torch.ones(shape, dtype=torch.result_type(z1, z2), device=z1.device)
    return torch.exp(-hamming_distance(z1, z2) / (num_vars * length_scale))


def hamming_kernel_matrix(num_vars: int, length_scale: float = 1.0, dtype=torch.float32,
                          device="cuda") -> torch.Tensor:
    """Dense (2^n, 2^n) Gram matrix ``K[i, j] = a^popcount(i ^ j)``, from the
    bits matrix by one matmul (``D = h1ᵀ + 1hᵀ - 2BBᵀ``); 4^n memory, so for
    moderate n only."""
    B = torch.as_tensor(all_bitstrings(num_vars), dtype=dtype, device=device)
    h = B.sum(dim=1)
    D = h[:, None] + h[None, :] - 2.0 * (B @ B.T)
    return torch.pow(torch.tensor(decay_factor(num_vars, length_scale), dtype=dtype,
                                  device=device), D)
