"""The entangling structure of a layer: CNOT basis maps, the CNOT chain and
the CZ pairs. Counterpart of ``_cnot_map``, ``_chain_gates`` and
``_cz_pairs`` in ``tensornetworks_tpu/sim/blocked.py``."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _cnot_map(idx: np.ndarray, n: int, c: int, t: int) -> np.ndarray:
    """Forward basis-state map of CNOT(control=c, target=t) on MSB-first ints."""
    cb = 1 << (n - 1 - c)
    tb = 1 << (n - 1 - t)
    return idx ^ (((idx & cb) >> (n - 1 - c)) * tb)


def _chain_gates(n: int, ansatz_type: str) -> List[Tuple[int, int]]:
    """The entangling CNOT sequence of one layer: nearest-neighbour chain and
    the ring wrap CNOT(n-1, 0) when n > 2."""
    gates = []
    if n > 1:
        for q in range(n - 1):
            gates.append((q, q + 1))
        if n > 2:
            gates.append((n - 1, 0))
    return gates


def _cz_pairs(n: int, layer: int, ansatz_type: str) -> List[Tuple[int, int]]:
    """CZ gates of one layer: skip links on even hardware_efficient layers,
    all pairs for all_to_all."""
    if ansatz_type == "hardware_efficient":
        if layer % 2 == 0 and n > 2:
            return [(q, q + 2) for q in range(0, n - 2, 2)]
        return []
    if ansatz_type == "all_to_all":
        return [(a, b) for a in range(n) for b in range(a + 1, n)] if n > 1 else []
    return []
