"""Hamming base kernel over {0,1}^n, in closed form.

Counterpart of ``tensornetworks_tpu/ops/hamming.py``. With
``a = exp(-1/(n*l))`` the kernel between two states is ``a^d`` for Hamming
distance ``d``; over all ``2^n`` states it is the Kronecker power
``A^{⊗n}``, ``A = [[1, a], [a, 1]]``.
"""

from __future__ import annotations

import numpy as np


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
