"""Bitstring enumeration and codecs over the discrete state space {0,1}^n.

Counterpart of ``tensornetworks_tpu/core/bits.py`` (host numpy, no JAX).

Convention: state index ``i`` encodes the bitstring MSB-first, i.e.
variable/qubit ``0`` is the **most significant** bit:
``bits(i)[k] = (i >> (n-1-k)) & 1`` (PennyLane's wire ordering for
``qml.probs``).
"""

from __future__ import annotations

import numpy as np


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


def flip_index(idx, num_vars: int, var: int):
    """Index of the state with variable ``var`` flipped (XOR with its bitmask)."""
    return idx ^ (1 << (num_vars - 1 - var))


def generate_all_binary_outcomes(num_vars: int) -> list:
    """All assignments as a list of tuples, in index order."""
    return [tuple(int(b) for b in row) for row in all_bitstrings(num_vars)]
