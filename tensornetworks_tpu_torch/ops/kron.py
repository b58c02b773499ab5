"""Kronecker-structured application of the Hamming base kernel, and of a
gate block to adjacent variables.

Counterpart of ``kron_power_np``, ``apply_adjacent_block``, ``kron_matvec``
and ``kron_matvec_rows`` in ``tensornetworks_tpu/ops/kron.py``. ``K = A^{⊗n}`` is applied to a
``(2^n, C)`` operand (or, ``kron_matvec_rows``, along the rows of a
``(C, 2^n)`` one) as a sequence of grouped adjacent-block contractions,
O(n·2^n·C) instead of the dense O(4^n·C). Variable 0 is the most
significant bit of the state index.

Reduced precision, as in the JAX package: ``kron_matvec(...,
compute_dtype=torch.bfloat16)`` and ``kron_matvec_rows`` of a bf16 operand
run each group pass on bf16 values with the products summed in the
accumulation dtype (FP32 for a bf16 operand; a bf16 product is exact there)
and round each pass's output back to bf16.
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


def apply_adjacent_block(v: torch.Tensor, M: torch.Tensor, start: int, g: int,
                         num_vars: int) -> torch.Tensor:
    """Apply M (2^g, 2^g) to the adjacent variable block [start, start+g)
    of a flat (2^n,) ``v``: one matmul over the (pre, 2^g, post) view, the
    (pre, 2^g) @ Mᵀ product when the block is last. ``M`` must not carry a
    lazy conjugate: the batched product would resolve it over the batch."""
    pre = 1 << start
    blk = 1 << g
    post = 1 << (num_vars - start - g)
    if post == 1:
        return (v.reshape(pre, blk) @ M.T).reshape(v.shape)
    if pre == 1:
        return (M @ v.reshape(blk, post)).reshape(v.shape)
    # bmm on M broadcast with a zero batch stride: no copy of M or of v, and
    # a contiguous result (torch.matmul transposes this case and copies).
    return torch.bmm(M.expand(pre, blk, blk), v.reshape(pre, blk, post)).reshape(v.shape)


def _kron_power(A: np.ndarray, g: int, dtype, device) -> torch.Tensor:
    """``A^{⊗g}`` in ``dtype``; a 16-bit dtype is reached through FP32."""
    M = torch.as_tensor(kron_power_np(A, g), dtype=torch.float32 if _low(dtype) else dtype,
                        device=device)
    return M.to(dtype)


def _low(dtype) -> bool:
    return dtype in (torch.bfloat16, torch.float16)


def kron_matvec(v: torch.Tensor, A: np.ndarray, num_vars: int, group: int = 7,
                compute_dtype=None) -> torch.Tensor:
    """(A^{⊗n}) @ v for ``v`` of shape ``(2^n,)`` or ``(2^n, C)``.

    The variables are cut into blocks of ``group`` (remainder first); each
    block's ``A^{⊗g}`` contracts the block's axis of the
    ``(pre, 2^g, post)`` view.

    ``compute_dtype`` (``torch.bfloat16``): v cast down, every pass on
    ``compute_dtype`` values with sums in v's dtype and its output cast back
    down, the result cast to v's dtype, as the JAX function does (about
    3e-3 relative error). Its passes follow the JAX function's grouping: the
    remainder last for several columns, first for one.
    """
    if num_vars == 0:
        return v
    if compute_dtype is not None:
        return _kron_matvec_low(v, A, num_vars, group, compute_dtype)
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


def _kron_matvec_low(v, A, num_vars: int, group: int, io) -> torch.Tensor:
    """``kron_matvec``'s passes on ``io`` values, summed in v's dtype."""
    acc, c = v.dtype, (v.shape[1] if v.ndim == 2 else 1)
    if c > 1:  # remainder last
        plan = [(s, min(group, num_vars - s)) for s in range(0, num_vars, group)]
    else:
        r = num_vars % group
        plan = ([(0, r)] if r else []) + [(s, group) for s in range(r, num_vars, group)]
    out = v.to(io)
    for start, g in plan:
        M = _kron_power(A, g, io, v.device).to(acc)
        post = (1 << (num_vars - start - g)) * c
        out = torch.einsum("ij,ajb->aib", M, out.to(acc).reshape(1 << start, 1 << g, post))
        out = out.to(io)
    return out.reshape(v.shape).to(acc)


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
    in balanced groups of variables. A bf16 (or fp16) ``v`` runs each pass
    on its values with FP32 sums and rounds the pass's output to its dtype,
    as the JAX function's bf16 einsums do."""
    if num_vars == 0:
        return v
    c = v.shape[0]
    acc = torch.float32 if _low(v.dtype) else v.dtype
    out = v
    for start, g in _group_plan_balanced(num_vars, group):
        M = _kron_power(A, g, v.dtype, v.device).to(acc)
        post = 1 << (num_vars - start - g)
        out = torch.einsum("ij,ajb->aib", M, out.to(acc).reshape(c << start, 1 << g, post))
        out = out.to(v.dtype)
    return out.reshape(c, -1)
