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
``K_p q`` is Kronecker applications of K to weighted copies of q and a
closed-form recombination. ``stein_matvec`` is the 3n+1-column oracle; the
gcorr form (``stein_matvec_gcorr_tables``) pushes only the n+1 columns
``[q; S_t∘q]`` through K and gets the 2n bit-masked ones in closed form,
``K(B_t∘v) = G_t (K v)`` with ``G = A·diag(0, 1)·A⁻¹`` on bit t. The
operator runs the gcorr form: its Kronecker apply through the stein2d CUDA
kernels, its recombination through the stein_gcorr kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.bits import all_bitstrings
from .hamming import decay_factor
from .kernels.stein2d import kron_factors, stein2d_apply, stein2d_apply_grid, stein2d_apply_plain
from .kernels.stein_gcorr import flip_bit, gcorr_combine
from .kron import kron_matvec, kron_matvec_rows

SCORE_EPS = 1e-12


def score_table(cond_joint: np.ndarray, eps: float = SCORE_EPS) -> np.ndarray:
    """Score matrix S[i, m] = 1 - p(x, flip_m z_i) / p(x, z_i), float64,
    (2^n, n). Rows with ``t < eps`` are zeroed. It is the transpose of a
    C-ordered (n, 2^n) array, so each score column is contiguous: the
    operator's tables take S column by column (3.2 GB at n=24)."""
    t = np.asarray(cond_joint, dtype=np.float64)
    size = t.shape[0]
    n = int(size).bit_length() - 1
    if 2**n != size:
        raise ValueError("conditional joint table length must be a power of 2")
    if n == 0:
        return np.zeros((1, 0), dtype=np.float64)
    St = np.empty((n, size), dtype=np.float64)
    zero = np.abs(t) < eps
    safe_t = np.where(zero, 1.0, t)
    for m in range(n):
        flipped = t.reshape(1 << m, 2, -1)[:, ::-1].reshape(-1)  # t[i ^ (1 << (n-1-m))]
        np.divide(flipped, safe_t, out=St[m])
        np.subtract(1.0, St[m], out=St[m])
        St[m, zero] = 0.0
    return St.T


def score_table_from_log(log_t: torch.Tensor, num_vars: int,
                         log_eps: float = float(np.log(SCORE_EPS))) -> torch.Tensor:
    """The score table (2^n, n) from a log joint table, on ``log_t``'s
    device: ``S[i, m] = 1 - exp(log_t[i ^ bit_m] - log_t[i])``, rows with
    ``log_t < log_eps`` zeroed (``score_table``'s guard in log space)."""
    if num_vars == 0:
        return torch.zeros((1, 0), dtype=log_t.dtype, device=log_t.device)
    idx = torch.arange(log_t.shape[0], device=log_t.device)
    S = torch.stack([1.0 - torch.exp(log_t[idx ^ (1 << (num_vars - 1 - m))] - log_t)
                     for m in range(num_vars)], dim=1)
    return torch.where(log_t[:, None] < log_eps, torch.zeros_like(S), S)


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

    This is the column build the TPU stein2d kernels consume. Both tables
    are built on the host in float64: two (61, 2^20) arrays of 0.5 GB each
    at n=20, which is why the operator runs the gcorr form instead."""
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


def _kron_apply(V: torch.Tensor, a: float, n: int, kron: str = "2d", group: int = 7):
    """``A^{⊗n}`` on every row of V (rows, 2^n) in plain torch: ``"2d"``, each
    row as an (R, C) matrix times ``A^{⊗rb}`` on the left and ``A^{⊗cb}ᵀ``
    on the right (the TPU stein2d kernel's split); ``"rows"``, the grouped
    row layout (``kron_matvec_rows``)."""
    if kron == "rows":
        return kron_matvec_rows(V, np.array([[1.0, a], [a, 1.0]]), n, group=group)
    if kron != "2d":
        raise ValueError(f"kron must be '2d' or 'rows', got {kron!r}")
    _, _, R, C = _split(n)
    Ar, Ac = kron_factors(a, R, C, V.dtype, V.device)
    return stein2d_apply_plain(Ar, Ac, V.reshape(-1, R, C)).reshape(V.shape)


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
    St, Bt = S.T, B.T
    SBt = St * Bt
    V = _stein_columns(q, St, Bt, SBt)
    if n >= 13:
        Y = _kron_apply(V, a, n)
    else:
        A = np.array([[1.0, a], [a, 1.0]])
        Y = kron_matvec(V.T.contiguous(), A, n, group=group).T
    return _recombine(Y, St, Bt, SBt, n, a)


def stein_matvec_gcorr(q: torch.Tensor, S: torch.Tensor, B: torch.Tensor, num_vars: int,
                       length_scale: float = 1.0, group: int = 7,
                       kron: str = "2d") -> torch.Tensor:
    """y = K_p @ q with only the n+1 columns ``[q; S_t∘q]`` through K: the
    derivation of the gcorr form. The 2n bit-masked columns commute through
    K in closed form, ``K(B_t∘v) = G_t(K v)`` with the 2x2 ``G = A P₁ A⁻¹ =
    [[-a², a], [-a, 1]] / (1 - a²)`` on bit t (``P₁ = diag(0, 1)``):

        P_t = K(B_t∘q)     = cs_t∘P0 + cf_t∘flip_t(P0),
        T_t = K(B_t∘S_t∘q) = cs_t∘Q_t + cf_t∘flip_t(Q_t),

    cs/cf the diagonal/off-diagonal entry of G selected by bit t; then the
    3n+1 form's recombination."""
    n = num_vars
    if n == 0:
        return torch.zeros_like(q)
    a = decay_factor(n, length_scale)
    inv = 1.0 / (1.0 - a * a)
    G00, G01, G10, G11 = -a * a * inv, a * inv, -a * inv, inv
    St, Bt = S.T, B.T
    Y = _kron_apply(torch.cat([q[None, :], St * q]), a, n, kron, group)
    P0, Q = Y[0], Y[1:]
    cs = G00 + (G11 - G00) * Bt
    cf = G01 + (G10 - G01) * Bt
    P = cs * P0 + cf * torch.stack([flip_bit(P0, t, n) for t in range(n)])
    T = cs * Q + cf * torch.stack([flip_bit(Q[t], t, n) for t in range(n)])
    return _recombine(torch.cat([P0[None, :], P, Q, T]), St, Bt, St * Bt, n, a)


class GcorrTables(NamedTuple):
    """The tables of ``stein_matvec_gcorr_tables``, θ-independent, built
    once per operator. Expanding the G-correction shows ``(1-2B_t)·cf_t =
    a/(1-a²)`` for every bit and state, and every same-bit sum collapses
    because ``G00 + G11 = 1``: no bits table is needed, only the score rows
    and their sum. (The JAX package's tables also hold the score rows
    pre-flipped per bit, ``Sfr``/``Sfc``, for its TPU layouts; the port's
    recombination gathers by ``i ^ m_t`` instead.)"""

    St: torch.Tensor  # (n, 2^n) score rows: the column build and Σ_t S_t∘Q_t
    Rv: torch.Tensor  # (2^n,) Σ_t S_t


def make_gcorr_tables(S, num_vars: int, length_scale: float = 1.0, dtype=None,
                      device=None) -> GcorrTables:
    """The gcorr tables of the score table S (2^n, n): a torch tensor, or a
    host numpy array (the operator's float64 score). They do not depend on
    the length scale. ``St`` is filled one score column at a time, cast where
    it lands, so no transposed host copy of the table is made (at n=24 the
    float64 score alone is 3.2 GB; ``score_table``'s columns are
    contiguous). ``dtype``/``device`` default to S's for a tensor, float32
    on the CPU for an array."""
    del length_scale
    if isinstance(S, torch.Tensor):
        dtype, device = dtype or S.dtype, device or S.device
    St = torch.empty((num_vars, S.shape[0]), dtype=dtype or torch.float32, device=device)
    for t in range(num_vars):
        St[t] = torch.as_tensor(S[:, t]).to(St.device)
    return GcorrTables(St=St, Rv=St.sum(dim=0))


def gcorr_columns(q: torch.Tensor, St: torch.Tensor) -> torch.Tensor:
    """The n+1 columns ``[q; S_t∘q]`` (n+1, 2^n) of the gcorr form."""
    return torch.cat([q[None, :], St * q])


def stein_matvec_gcorr_tables(q: torch.Tensor, tables: GcorrTables, num_vars: int,
                              length_scale: float = 1.0, group: int = 7,
                              kron: str = "rows") -> torch.Tensor:
    """y = K_p @ q from ``GcorrTables``, the production form: the n+1
    columns through K (``kron``: ``"2d"`` or ``"rows"``, plain torch), then
    the recombination ``gcorr_combine`` (its kernel on the card). Fully
    expanded, with P0 = K q, Q_t = K(S_t∘q), m_t the flip of bit t:

        y = Σ_t S_t∘Q_t + w1·(Rv∘P0 + Σ_t Q_t) + w0·P0
            + Σ_t [α·(S_t∘P0[· ^ m_t] + Q_t[· ^ m_t]) + γ·P0[· ^ m_t]]

    The JAX function's ``corr`` argument picks one of three TPU layouts of
    the flip sum; they compute this same function."""
    n = num_vars
    if n == 0:
        return torch.zeros_like(q)
    a = decay_factor(n, length_scale)
    Y = _kron_apply(gcorr_columns(q, tables.St), a, n, kron, group)
    return gcorr_combine(Y[0], Y[1:], tables.St, tables.Rv, a, n)


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


def ksd_quadform_gcorr(q: torch.Tensor, tables: GcorrTables, num_vars: int,
                       length_scale: float = 1.0, group: int = 7,
                       kron: str = "rows") -> torch.Tensor:
    """qᵀ K_p q via ``stein_matvec_gcorr_tables``; differentiable in q only."""
    return _QuadForm.apply(q, lambda v: stein_matvec_gcorr_tables(
        v, tables, num_vars, length_scale, group, kron))


class SteinOperator:
    """Precomputed Stein operator for one (BN, observation, kernel).

    ``dense=True`` (default for n ≤ 12) materializes K_p once; otherwise the
    quadratic form runs the gcorr n+1-column matvec: the columns ``[q;
    S_t∘q]`` through a stein2d kernel (``ops/kernels/stein2d.py``, which
    takes its plain version on the CPU) — the one-launch cluster butterfly
    ``stein2d_apply`` for n ≤ 17, the two-pass butterfly
    ``stein2d_apply_grid`` from n = 18, both taking the decay factor ``a``
    alone — and the recombination through ``gcorr_combine``. Its tables are
    ``GcorrTables`` on the device, (n+1)·2^n floats; the score stays on the
    host as the numpy array it was given, and ``S`` and ``B`` are built on
    the device only when touched (the dense Gram, the 3n+1 oracle).
    """

    DENSE_MAX_VARS = 12
    GRID_MIN_VARS = 18

    def __init__(self, score: np.ndarray, num_vars: int, length_scale: float = 1.0,
                 dtype=torch.float32, dense: bool | None = None, device="cuda"):
        n = num_vars
        self.num_vars = n
        self.length_scale = float(length_scale)
        self.dtype = dtype
        self.device = torch.device(device)
        self._score_np = np.asarray(score)
        self._S = self._B = None
        self.dense = dense if dense is not None else n <= self.DENSE_MAX_VARS
        self.gram = self.gcorr = None
        if self.dense:
            self.gram = stein_gram_dense(self.S, n, self.length_scale)
            return
        self._a = decay_factor(n, self.length_scale)
        _, _, self._R, self._C = _split(n)
        self._grid = n >= self.GRID_MIN_VARS
        self.gcorr = make_gcorr_tables(self._score_np, n, dtype=dtype, device=self.device)

    @property
    def S(self) -> torch.Tensor:
        """The score table (2^n, n) on the device, built at first use."""
        if self._S is None:
            self._S = torch.as_tensor(self._score_np, dtype=self.dtype, device=self.device)
        return self._S

    @property
    def B(self) -> torch.Tensor:
        """The bits table (2^n, n) on the device, built at first use."""
        if self._B is None:
            self._B = torch.as_tensor(all_bitstrings(self.num_vars), dtype=self.dtype,
                                      device=self.device)
        return self._B

    def columns(self, q: torch.Tensor) -> torch.Tensor:
        """The n+1 columns ``[q; S_t∘q]`` as (n+1, R, C) blocks."""
        return gcorr_columns(q, self.gcorr.St).reshape(-1, self._R, self._C)

    def kron_apply(self, V: torch.Tensor) -> torch.Tensor:
        """``A^{⊗n}`` on every (R, C) block of V through the path's kernel."""
        return (stein2d_apply_grid if self._grid else stein2d_apply)(self._a, V)

    def matvec(self, q: torch.Tensor) -> torch.Tensor:
        if self.dense:
            return self.gram @ q
        Y = self.kron_apply(self.columns(q)).reshape(self.num_vars + 1, -1)
        return gcorr_combine(Y[0], Y[1:], self.gcorr.St, self.gcorr.Rv, self._a, self.num_vars)

    def quadform(self, q: torch.Tensor) -> torch.Tensor:
        """qᵀ K_p q (the squared KSD of the distribution q)."""
        if self.dense:
            return torch.dot(q, self.gram @ q)
        return _QuadForm.apply(q, self.matvec)

    def ksd_loss(self, q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
        """sqrt(clamp(qᵀ K_p q, eps))."""
        return torch.sqrt(torch.clamp(self.quadform(q), min=eps))
