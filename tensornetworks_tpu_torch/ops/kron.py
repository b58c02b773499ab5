"""Kronecker-structured application of the Hamming base kernel.

Counterpart of ``kron_power_np``, ``kron_matvec`` and ``kron_matvec_rows``
in ``tensornetworks_tpu/ops/kron.py``. ``K = A^{⊗n}`` is applied to a
``(2^n, C)`` operand (or, ``kron_matvec_rows``, along the rows of a
``(C, 2^n)`` one) as a sequence of grouped adjacent-block contractions,
O(n·2^n·C) instead of the dense O(4^n·C). Variable 0 is the most
significant bit of the state index.
"""

from __future__ import annotations

import numpy as np
import torch


def kron_power_np(A: np.ndarray, g: int) -> np.ndarray:
    """A^{⊗g} as a dense (2^g, 2^g) numpy array (host, float64)."""
    M = np.array([[1.0]], dtype=np.float64)
    for _ in range(g):
        M = np.kron(M, np.asarray(A, dtype=np.float64))
    return M


def kron_matvec(v: torch.Tensor, A: np.ndarray, num_vars: int, group: int = 7) -> torch.Tensor:
    """(A^{⊗n}) @ v for ``v`` of shape ``(2^n,)`` or ``(2^n, C)``.

    The variables are cut into blocks of ``group`` (remainder first); each
    block's ``A^{⊗g}`` contracts the block's axis of the
    ``(pre, 2^g, post)`` view.
    """
    if num_vars == 0:
        return v
    r = num_vars % group
    plan = ([(0, r)] if r else []) + [(s, group) for s in range(r, num_vars, group)]
    c = v.shape[1] if v.ndim == 2 else 1
    out = v
    for start, g in plan:
        M = torch.as_tensor(kron_power_np(A, g), dtype=v.dtype, device=v.device)
        pre = 1 << start
        post = (1 << (num_vars - start - g)) * c
        out = torch.einsum("ij,ajb->aib", M, out.reshape(pre, 1 << g, post))
    return out.reshape(v.shape)


def _group_plan_balanced(num_vars: int, group: int):
    """The fewest groups of at most ``group + 1`` variables, sizes balanced
    (the larger ones first): ``[(start, size), ...]``."""
    if num_vars == 0:
        return []
    k = -(-num_vars // (group + 1))
    base, rem = divmod(num_vars, k)
    sizes = [base + 1] * rem + [base] * (k - rem)
    starts = np.cumsum([0] + sizes[:-1])
    return [(int(s), g) for s, g in zip(starts, sizes)]


def kron_matvec_rows(v: torch.Tensor, A: np.ndarray, num_vars: int, group: int = 7) -> torch.Tensor:
    """(A^{⊗n}) applied along the trailing state axis of every row of a
    ``(C, 2^n)`` operand (the row layout of the JAX package's n ≥ 18 path),
    in balanced groups of variables."""
    if num_vars == 0:
        return v
    c = v.shape[0]
    out = v
    for start, g in _group_plan_balanced(num_vars, group):
        M = torch.as_tensor(kron_power_np(A, g), dtype=v.dtype, device=v.device)
        post = 1 << (num_vars - start - g)
        out = torch.einsum("ij,ajb->aib", M, out.reshape(c << start, 1 << g, post))
    return out.reshape(c, -1)
