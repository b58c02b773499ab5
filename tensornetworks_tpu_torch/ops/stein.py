"""Discrete kernelized Stein discrepancy over {0,1}^n as dense linear algebra.

Counterpart of ``tensornetworks_tpu/ops/stein.py``. The Stein kernel
``K_p`` does not depend on θ: it is fixed by the Bayesian network (through
the score table S) and the base Hamming kernel, so each training step is
``loss = sqrt(qᵀ K_p q)``.

With ``a = exp(-1/(n·l))``, ``K = A^{⊗n}`` and bits matrix ``B``,
``K_p = K ∘ W`` where (c1 = 1-1/a, c2 = 1-a, R = S·1, D = Hamming distance,
T1[i,j] = Σ_{m: bit_m(i^j)=1} S[i,m]):

    W = S Sᵀ - c1·(T1 + T1ᵀ) - c2·(R 1ᵀ + 1 Rᵀ - T1 - T1ᵀ)
        + 2n(1-a) - 2(1/a - a)·D

For n ≤ 12 the Gram is built once (``stein_gram_dense``); above that
``K_p q`` is 3n+1 Kronecker applications of K to weighted copies of q and a
closed-form recombination (``stein_matvec``). The operator's large-n path
runs those Kronecker applications through the stein2d CUDA kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bits import all_bitstrings
from .hamming import decay_factor
from .kernels.stein2d import stein2d_apply, stein2d_apply_grid, stein2d_apply_plain
from .kron import kron_matvec, kron_power_np

SCORE_EPS = 1e-12


def score_table(cond_joint: np.ndarray, eps: float = SCORE_EPS) -> np.ndarray:
    """Score matrix S[i, m] = 1 - p(x, flip_m z_i) / p(x, z_i), float64.
    Rows with ``t < eps`` are zeroed."""
    t = np.asarray(cond_joint, dtype=np.float64)
    size = t.shape[0]
    n = int(size).bit_length() - 1
    if 2**n != size:
        raise ValueError("conditional joint table length must be a power of 2")
    if n == 0:
        return np.zeros((1, 0), dtype=np.float64)
    idx = np.arange(size, dtype=np.int64)
    S = np.zeros((size, n), dtype=np.float64)
    safe_t = np.where(np.abs(t) < eps, 1.0, t)
    for m in range(n):
        flipped = idx ^ (1 << (n - 1 - m))
        S[:, m] = 1.0 - t[flipped] / safe_t
    S[np.abs(t) < eps, :] = 0.0
    return S


def stein_gram_dense(S: torch.Tensor, num_vars: int, length_scale: float = 1.0) -> torch.Tensor:
    """The full (2^n, 2^n) Stein Gram matrix K_p, in S's dtype and device."""
    if num_vars == 0:
        return torch.zeros((1, 1), dtype=S.dtype, device=S.device)
    B = torch.as_tensor(all_bitstrings(num_vars), dtype=S.dtype, device=S.device)
    a = decay_factor(num_vars, length_scale)
    h = B.sum(dim=1)
    D = h[:, None] + h[None, :] - 2.0 * (B @ B.T)
    K = torch.pow(torch.tensor(a, dtype=S.dtype, device=S.device), D)
    G = S @ S.T
    u = (S * B).sum(dim=1)
    T1 = u[:, None] + S @ B.T - 2.0 * ((S * B) @ B.T)
    R = S.sum(dim=1)
    c1 = 1.0 - 1.0 / a
    c2 = 1.0 - a
    W = (G - c1 * (T1 + T1.T) - c2 * (R[:, None] + R[None, :] - T1 - T1.T)
         + 2.0 * num_vars * (1.0 - a) - 2.0 * (1.0 / a - a) * D)
    return K * W


def _stein_columns(q, St, Bt, SBt) -> torch.Tensor:
    """The 3n+1 weighted copies of q, rows layout (3n+1, 2^n)."""
    return torch.cat([q[None, :], Bt * q, St * q, SBt * q], dim=0)


def _recombine(Y, St, Bt, SBt, n: int, a: float) -> torch.Tensor:
    """K_p q from the Kronecker-applied columns Y = K V (rows layout)."""
    P0, P = Y[0], Y[1:n + 1]
    Q, T = Y[n + 1:2 * n + 1], Y[2 * n + 1:]
    u = SBt.sum(dim=0)
    Rv = St.sum(dim=0)
    h = Bt.sum(dim=0)
    c1 = 1.0 - 1.0 / a
    c2 = 1.0 - a
    term_G = (St * Q).sum(dim=0)
    y_T1 = u * P0 + (St * (1.0 - 2.0 * Bt) * P).sum(dim=0)
    y_T1t = T.sum(dim=0) + (Bt * (Q - 2.0 * T)).sum(dim=0)
    y_Ri = Rv * P0
    y_Rj = Q.sum(dim=0)
    y_D = h * P0 + P.sum(dim=0) - 2.0 * (Bt * P).sum(dim=0)
    return (term_G
            - c1 * (y_T1 + y_T1t)
            - c2 * (y_Ri + y_Rj - y_T1 - y_T1t)
            + 2.0 * n * (1.0 - a) * P0
            - 2.0 * (1.0 / a - a) * y_D)


def stein_weight_tables(S: np.ndarray, num_vars: int, length_scale: float = 1.0):
    """(Vw, W), each (3n+1, 2^n) float64: the column build is ``V = Vw ∘ q``
    and, ``K_p q`` being linear in the Kronecker-applied columns ``Y = K V``,
    the recombination above is ``y = Σ_rows W ∘ Y``. With k = c1 - c2 and
    d = 2(1/a - a), the rows of W weigh P0, P_t, Q_t, T_t by

        P0:  2n(1-a) - k·u - c2·R - d·h
        P_t: -(k·S_t + d)(1 - 2B_t)
        Q_t: S_t - k·B_t - c2
        T_t: -k(1 - 2B_t)

    Both tables depend on the network and the kernel only, so the operator
    builds them once and an epoch pays one product on each side.

    They are built on the host in float64: at n=20 two (61, 2^20) arrays of
    0.5 GB each, with temporaries of the same order. From n ≈ 22 that is
    what the JAX package's lazily built S/B and gcorr tables avoid (ROADMAP
    A7, not ported yet)."""
    n = num_vars
    a = decay_factor(n, length_scale)
    St = np.asarray(S, dtype=np.float64).T
    Bt = all_bitstrings(n).T.astype(np.float64)
    c1, c2 = 1.0 - 1.0 / a, 1.0 - a
    k, d = c1 - c2, 2.0 * (1.0 / a - a)
    one2b = 1.0 - 2.0 * Bt
    w0 = (2.0 * n * (1.0 - a) - k * (St * Bt).sum(axis=0) - c2 * St.sum(axis=0)
          - d * Bt.sum(axis=0))
    W = np.vstack([w0[None], -(k * St + d) * one2b, St - k * Bt - c2, -k * one2b])
    Vw = np.vstack([np.ones((1, 1 << n)), Bt, St, St * Bt])
    return np.ascontiguousarray(Vw), np.ascontiguousarray(W)


def _split(n: int):
    rb = (n + 1) // 2
    return rb, n - rb, 1 << rb, 1 << (n - rb)


def stein_matvec(q: torch.Tensor, S: torch.Tensor, B: torch.Tensor, num_vars: int,
                 length_scale: float = 1.0, group: int = 7) -> torch.Tensor:
    """y = K_p @ q without materializing K_p: the 3n+1-column oracle.

    From n = 13 each column, viewed as an (R, C) matrix, is multiplied as
    ``A^{⊗rb} V A^{⊗cb}ᵀ`` (the two-sided split of the TPU stein2d kernel,
    here in plain torch); below, the columns go through the grouped
    Kronecker matvec. The JAX package switches its n ≥ 18 branch to a
    grouped row layout, which computes the same product.
    """
    n = num_vars
    if n == 0:
        return torch.zeros_like(q)
    a = decay_factor(n, length_scale)
    A = np.array([[1.0, a], [a, 1.0]])
    St, Bt = S.T, B.T
    SBt = St * Bt
    V = _stein_columns(q, St, Bt, SBt)
    if n >= 13:
        rb, cb, R, C = _split(n)
        Ar = torch.as_tensor(kron_power_np(A, rb), dtype=q.dtype, device=q.device)
        Ac = torch.as_tensor(kron_power_np(A, cb), dtype=q.dtype, device=q.device)
        Y = stein2d_apply_plain(Ar, Ac, V.reshape(-1, R, C)).reshape(V.shape)
    else:
        Y = kron_matvec(V.T.contiguous(), A, n, group=group).T
    return _recombine(Y, St, Bt, SBt, n, a)


class _QuadForm(torch.autograd.Function):
    """qᵀ K_p q through a matvec. K_p is symmetric, so the gradient is
    ``2·g·K_p q``: the forward matvec is reused and the tables get none."""

    @staticmethod
    def forward(ctx, q, matvec):
        y = matvec(q)
        ctx.save_for_backward(y)
        return torch.dot(q, y)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return 2.0 * g * y, None


def ksd_quadform(q: torch.Tensor, S: torch.Tensor, B: torch.Tensor, num_vars: int,
                 length_scale: float = 1.0, group: int = 7) -> torch.Tensor:
    """qᵀ K_p q via ``stein_matvec``; differentiable in q only."""
    return _QuadForm.apply(
        q, lambda v: stein_matvec(v, S, B, num_vars, length_scale, group))


class SteinOperator:
    """Precomputed Stein operator for one (BN, observation, kernel).

    ``dense=True`` (default for n ≤ 12) materializes K_p once; otherwise the
    quadratic form runs the 3n+1-column matvec — column build and
    recombination through the precomputed ``stein_weight_tables``, the
    Kronecker applications through a stein2d kernel
    (``ops/kernels/stein2d.py``, which takes its plain version on the CPU):
    the one-launch cluster butterfly ``stein2d_apply`` for n ≤ 17, the
    two-pass butterfly ``stein2d_apply_grid`` from n = 18; both take the
    decay factor ``a`` alone.
    """

    DENSE_MAX_VARS = 12
    GRID_MIN_VARS = 18

    def __init__(self, score: np.ndarray, num_vars: int, length_scale: float = 1.0,
                 dtype=torch.float32, dense: bool | None = None, device="cuda"):
        n = num_vars
        self.num_vars = n
        self.length_scale = float(length_scale)
        self.dense = dense if dense is not None else n <= self.DENSE_MAX_VARS
        if self.dense:
            S = torch.as_tensor(np.asarray(score), dtype=dtype, device=device)
            self.gram = stein_gram_dense(S, n, self.length_scale)
            return
        self.gram = None
        self._a = decay_factor(n, self.length_scale)
        _, _, self._R, self._C = _split(n)
        self._grid = n >= self.GRID_MIN_VARS
        Vw, W = stein_weight_tables(score, n, self.length_scale)
        self._Vw = torch.as_tensor(Vw, dtype=dtype, device=device)
        self._W = torch.as_tensor(W, dtype=dtype, device=device)

    def kron_apply(self, V: torch.Tensor) -> torch.Tensor:
        """``A^{⊗n}`` on every (R, C) block of V through the path's kernel."""
        return (stein2d_apply_grid if self._grid else stein2d_apply)(self._a, V)

    def matvec(self, q: torch.Tensor) -> torch.Tensor:
        if self.dense:
            return self.gram @ q
        V = (self._Vw * q).reshape(-1, self._R, self._C)
        Y = self.kron_apply(V)
        return (self._W * Y.reshape(self._W.shape)).sum(dim=0)

    def quadform(self, q: torch.Tensor) -> torch.Tensor:
        """qᵀ K_p q (the squared KSD of the distribution q)."""
        if self.dense:
            return torch.dot(q, self.gram @ q)
        return _QuadForm.apply(q, self.matvec)

    def ksd_loss(self, q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
        """sqrt(clamp(qᵀ K_p q, eps))."""
        return torch.sqrt(torch.clamp(self.quadform(q), min=eps))
