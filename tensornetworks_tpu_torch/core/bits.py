"""Bitstring enumeration and codecs over the discrete state space {0,1}^n.

Counterpart of ``tensornetworks_tpu/core/bits.py``: host numpy, and the
index ↔ bit-row codecs on torch tensors for sample batches on the device.

Convention: state index ``i`` encodes the bitstring MSB-first, i.e.
variable/qubit ``0`` is the **most significant** bit:
``bits(i)[k] = (i >> (n-1-k)) & 1`` (PennyLane's wire ordering for
``qml.probs``).
"""

from __future__ import annotations

import numpy as np
import torch


def all_bitstrings(num_vars: int, dtype=np.int8) -> np.ndarray:
    """(2^n, n) matrix whose row i is the MSB-first binary expansion of i."""
    if num_vars == 0:
        return np.zeros((1, 0), dtype=dtype)
    idx = np.arange(2**num_vars, dtype=np.int64)
    shifts = np.arange(num_vars - 1, -1, -1, dtype=np.int64)
    return ((idx[:, None] >> shifts[None, :]) & 1).astype(dtype)


def bits_to_index(bits: np.ndarray) -> np.ndarray:
    """Inverse of ``all_bitstrings``: rows of bits -> integer indices."""
    bits = np.asarray(bits)
    n = bits.shape[-1]
    if n == 0:
        return np.zeros(bits.shape[:-1], dtype=np.int64)
    weights = 1 << np.arange(n - 1, -1, -1, dtype=np.int64)
    return (bits.astype(np.int64) * weights).sum(axis=-1)


def torch_bits_to_index(bits: torch.Tensor) -> torch.Tensor:
    """``bits_to_index`` on a tensor of bit rows (int64 indices, same device)."""
    n = bits.shape[-1]
    weights = 1 << torch.arange(n - 1, -1, -1, dtype=torch.int64, device=bits.device)
    return (bits.to(torch.int64) * weights).sum(dim=-1)


def torch_index_to_bits(idx: torch.Tensor, num_vars: int, dtype=torch.float32) -> torch.Tensor:
    """Integer indices -> MSB-first bit rows of ``dtype``, on idx's device."""
    shifts = torch.arange(num_vars - 1, -1, -1, dtype=torch.int64, device=idx.device)
    return ((idx.to(torch.int64)[..., None] >> shifts) & 1).to(dtype)


def flip_index(idx, num_vars: int, var: int):
    """Index of the state with variable ``var`` flipped (XOR with its bitmask)."""
    return idx ^ (1 << (num_vars - 1 - var))


def generate_all_binary_outcomes(num_vars: int) -> list:
    """All assignments as a list of tuples, in index order."""
    return [tuple(int(b) for b in row) for row in all_bitstrings(num_vars)]
