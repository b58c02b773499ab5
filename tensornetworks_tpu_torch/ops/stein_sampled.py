"""Sampled (U-statistic) kernelized Stein discrepancy.

Counterpart of ``tensornetworks_tpu/ops/stein_sampled.py``. The exact
operator (``ops/stein.py``) enumerates {0,1}^n; this module evaluates the
same Stein kernel ``k_p(x, y)`` on batches of M samples:

- ``stein_gram_samples``: the (M, M) Gram over sampled bit rows, the closed
  form ``K ∘ W`` of ``stein_gram_dense`` with the sample matrix in place of
  all bitstrings (on the full enumeration it is ``stein_gram_dense``);
- ``score_at_samples``: score rows s(z) from a factored ``log p(x, z)``
  (``core/factors.py``), O(n·N) per sample, with the reference's
  zero-probability guard in log space;
- ``ksd_ustat`` / ``ksd_vstat``: unbiased / biased KSD² from a Gram;
- ``reinforce_surrogate``: a scalar whose gradient is the score-function
  estimator of ∇θ KSD², with the leave-one-out, mean or no baseline;
- ``reinforce_surrogate_cv``: the same with a linear-in-bits control
  variate whose expectation is restored through the bit marginals;
- ``reinforce_surrogate_weighted``: the exact-expectation form, whose
  gradient is ∇θ (qᵀ K_p q) (the test oracle).

The Gram is plain torch matmuls: the JAX package computes it in XLA, outside
any Pallas kernel. Every ``detach`` below is a ``stop_gradient`` there.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from .hamming import decay_factor
from .stein import SCORE_EPS


def stein_gram_samples(S_x: torch.Tensor, X: torch.Tensor, num_vars: int,
                       length_scale: float = 1.0) -> torch.Tensor:
    """(M, M) Stein Gram over sample rows ``X`` with score rows ``S_x``:
    products of (M, n) factors, O(M²·n) whatever 2^n is."""
    X = X.to(S_x.dtype)
    a = decay_factor(num_vars, length_scale)
    h = X.sum(dim=1)
    D = h[:, None] + h[None, :] - 2.0 * (X @ X.T)
    K = torch.pow(torch.tensor(a, dtype=S_x.dtype, device=S_x.device), D)
    G = S_x @ S_x.T
    u = (S_x * X).sum(dim=1)
    T1 = u[:, None] + S_x @ X.T - 2.0 * ((S_x * X) @ X.T)
    R = S_x.sum(dim=1)
    c1 = 1.0 - 1.0 / a
    c2 = 1.0 - a
    W = (G
         - c1 * (T1 + T1.T)
         - c2 * (R[:, None] + R[None, :] - T1 - T1.T)
         + 2.0 * num_vars * (1.0 - a)
         - 2.0 * (1.0 / a - a) * D)
    return K * W


def score_at_samples(log_joint_latent_fn: Callable, Z: torch.Tensor,
                     eps: float = SCORE_EPS) -> torch.Tensor:
    """Score rows ``s_m(z) = 1 - p(x, flip_m z) / p(x, z)`` for sampled
    ``Z`` (M, n); rows with ``p(x, z) < eps`` are zeroed (the reference's
    guard, ``stein_utils.py:115-136``)."""
    Z = Z.to(torch.int64)
    n = Z.shape[-1]
    lp = log_joint_latent_fn(Z)                                          # (M,)
    flips = Z[..., None, :] ^ torch.eye(n, dtype=torch.int64, device=Z.device)  # (M, n, n)
    lpf = log_joint_latent_fn(flips)                                     # (M, n)
    s = 1.0 - torch.exp(lpf - lp[..., None])
    return torch.where(lp[..., None] < math.log(eps), torch.zeros_like(s), s)


def ksd_ustat(gram: torch.Tensor) -> torch.Tensor:
    """Unbiased KSD² estimate: the mean of the off-diagonal Gram entries."""
    M = gram.shape[0]
    return (gram.sum() - torch.trace(gram)) / (M * (M - 1))


def ksd_vstat(gram: torch.Tensor) -> torch.Tensor:
    """Biased (V-statistic) KSD² estimate: the mean of all Gram entries."""
    M = gram.shape[0]
    return gram.sum() / (M * M)


def _loo_weights(gram: torch.Tensor):
    """(Σ_{j≠i} g_ij, its mean over the M - 1 partners) of the detached Gram."""
    g = gram.detach()
    row = g.sum(dim=1) - torch.diagonal(g)
    return row, row / (gram.shape[0] - 1)


def reinforce_surrogate(gram: torch.Tensor, log_q: torch.Tensor,
                        baseline: str = "loo") -> torch.Tensor:
    """Scalar whose θ-gradient estimates ∇θ KSD² (U-statistic form):
    ``(2/M) Σ_i (w_i - b_i) ∇log q(z_i)`` with ``w_i = mean_{j≠i} g_ij``
    and the Gram held constant. ``baseline``:

    - ``"loo"``: b_i is the mean of the off-diagonal entries over pairs
      that exclude sample i, a function of the other samples only, so the
      estimator stays exactly unbiased; with M < 3 there are no such pairs
      and it is ``"none"``;
    - ``"mean"``: the mean of the w's (O(1/M)-biased);
    - ``"none"``.
    """
    M = gram.shape[0]
    row, w = _loo_weights(gram)
    if baseline == "loo" and M >= 3:
        # Off-diagonal total minus both occurrences of row i (symmetric):
        # Σ_{j≠k; j,k≠i} g_jk over (M-1)(M-2) ordered pairs.
        w = w - (row.sum() - 2.0 * row) / ((M - 1) * (M - 2))
    elif baseline == "mean":
        w = w - w.mean()
    elif baseline not in ("none", "loo"):
        raise ValueError(f"baseline must be loo|mean|none, got {baseline!r}")
    return 2.0 * (w * log_q).mean()


def _cg_solve(A: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Fixed-iteration conjugate gradients for a small SPD system: the JAX
    package's iterates (it avoids a LU solve inside its scan), exact in
    exact arithmetic after n iterations of an n×n system."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = r @ r
    for _ in range(iters):
        Ap = A @ p
        alpha = rs / (p @ Ap + 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = r @ r
        p = r + (rs_new / (rs + 1e-30)) * p
        rs = rs_new
    return x


def fit_linear_control_variate(w: torch.Tensor, Z: torch.Tensor, ridge: float = 1e-3):
    """Ridge fit ``w ≈ w̄ + (Z − Z̄)·β`` on the batch, all detached; the
    ridge is relative to the mean feature variance. Returns
    ``(beta, w_mean, z_mean)``."""
    w = w.detach()
    Z = Z.detach()
    M, n = Z.shape
    zm = Z.mean(dim=0)
    Zc = Z - zm
    wc = w - w.mean()
    C = (Zc.T @ Zc) / M
    lam = ridge * (torch.trace(C) / n) + 1e-30
    beta = _cg_solve(C + lam * torch.eye(n, dtype=Z.dtype, device=Z.device), (Zc.T @ wc) / M,
                     iters=max(2 * n, 16))
    return beta, w.mean(), zm


def reinforce_surrogate_cv(gram: torch.Tensor, log_q: torch.Tensor, Z: torch.Tensor,
                           bit_marginals: torch.Tensor, ridge: float = 1e-3) -> torch.Tensor:
    """REINFORCE surrogate with a regression control variate
    ``c(z) = w̄ + (z − z̄)·β`` fitted on the batch:

        ∇ surrogate = (2/M) Σ_i (w_i − c(z_i)) ∇log q(z_i) + 2 β·∇m(θ)

    where ``bit_marginals`` m(θ) = E_qθ[z] must come from the same
    differentiable distribution as ``log_q`` (the engine reduces the (R, C)
    view along each axis). Unbiased for a fixed β; the batch fit couples β
    to each z_i at O(1/M)."""
    _, w = _loo_weights(gram)
    beta, wm, zm = fit_linear_control_variate(w, Z, ridge)
    c = wm + (Z.detach() - zm) @ beta
    # E_qθ[c] = w̄ + (m(θ) − z̄)·β: only β·m(θ) carries a θ-gradient.
    return 2.0 * ((w - c) * log_q).mean() + 2.0 * (beta @ bit_marginals)


def reinforce_surrogate_weighted(gram: torch.Tensor, log_q: torch.Tensor,
                                 weights: torch.Tensor) -> torch.Tensor:
    """Exact-expectation form: rows are all outcomes and ``weights`` their
    (detached) probabilities; the gradient is ∇θ (qᵀ K_p q) exactly."""
    wgt = weights.detach()
    row = gram.detach() @ wgt
    return 2.0 * (wgt * row * log_q).sum()
