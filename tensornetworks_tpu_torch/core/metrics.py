"""Distribution metrics (TVD, KL, entropy) over dicts or dense vectors.

Counterpart of ``tensornetworks_tpu/core/metrics.py``: ``calculate_tvd`` on
the host, the rest on torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def calculate_tvd(p_true, p_approx) -> float:
    """Total variation distance. Accepts two dicts (union of keys) or two
    equal-shape arrays."""
    if isinstance(p_true, dict) and isinstance(p_approx, dict):
        all_outcomes = set(p_true) | set(p_approx)
        return 0.5 * float(
            sum(abs(p_true.get(o, 0.0) - p_approx.get(o, 0.0)) for o in all_outcomes)
        )
    p_true = np.asarray(p_true)
    p_approx = np.asarray(p_approx)
    if p_true.shape != p_approx.shape:
        raise ValueError("Probability arrays must have the same shape for simple TVD calculation.")
    return 0.5 * float(np.abs(p_true - p_approx).sum())


def tvd(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """TVD between dense probability vectors (last axis)."""
    return 0.5 * (p - q).abs().sum(dim=-1)


def entropy(p: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Shannon entropy -sum p log p with a 1e-10 clamp."""
    return -(p * torch.log(p.clamp(min=eps))).sum(dim=-1)


def kl_divergence(p: torch.Tensor, q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """KL(p || q) with clamping, for diagnostics."""
    return (p * (torch.log(p.clamp(min=eps)) - torch.log(q.clamp(min=eps)))).sum(dim=-1)
