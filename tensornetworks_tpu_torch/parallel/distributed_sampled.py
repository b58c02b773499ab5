"""Two-stage measurement sampling on a state-sharded register.

Counterpart of ``tensornetworks_tpu/parallel/distributed_sampled.py``. The
sampled-KSD engine builds no 2^n Stein structure, but the Born machine's
probabilities are still 2^n; this module shards the sampling side over the
mesh's ``state`` axis so that every 2^n buffer stays 2^n/D per rank, while
the estimator's per-shot structures (bits, scores, the (M, M) Gram) are
replicated: O(M·n + M²), independent of 2^n.

``sample(P2_local, u_r, u_c)`` draws exactly the shots of
``sim.sampling.sample_indices_2d`` on the gathered (R, C) matrix with the
same uniforms, bit for bit: stage 1 draws the rows (the high bits, which
hold the global ones) from the all-gathered (R,) row-marginal CDF, an
R ≈ 2^(n/2) collective; stage 2 takes each shot's raw row from the rank
that owns it, sums the masked rows over the ranks (``psum_replicated``:
each row has one nonzero summand, so the sum is exact) and draws the column
from the M gathered rows. The rows stay differentiable, so ``q`` at the
shots back-propagates into the owning shard (the psum's backward passes
the replicated cotangent through, the mask keeps this rank's rows) and on
through the sharded circuit. The CDFs are ``sim.sampling``'s scans, whose
float sums run in an order fixed by their length on the card as well: a
device-wide scan's order varies from run to run, so the ranks, each
scanning the same gathered marginals, could draw different rows.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..sim.sampling import _cumsum
from .comm import all_gather, psum_replicated
from .mesh import STATE_AXIS, axis_index, axis_size
from .shard_state import num_global_bits


def make_distributed_two_stage_sampler(mesh: DeviceMesh, num_vars: int, num_samples: int,
                                       eps: float = 1e-10):
    """``sample(P2_local, u_r, u_c) -> (flat_idx, q_at)`` for this rank's
    rows (R/D, C) of the (R, C) = (2^⌈n/2⌉, 2^⌊n/2⌋) probability view:
    ``flat_idx`` (M,) and the differentiable ``q_at = P2[r, c]``, the same on
    every rank, equal to ``sample_indices_2d`` + ``gather_2d`` on the full
    matrix with the uniforms ``u_r``, ``u_c`` (M,) (same smoothing, same CDF
    normalisation). R must be divisible by the state-axis rank count."""
    n, M = num_vars, num_samples
    rb = (n + 1) // 2
    R, C = 1 << rb, 1 << (n - rb)
    D = axis_size(mesh, STATE_AXIS)
    num_global_bits(mesh)  # validates a power-of-two axis
    if R % D != 0:
        raise ValueError(f"row extent {R} not divisible by {D} devices")
    Rl = R // D
    off = axis_index(mesh, STATE_AXIS) * Rl

    def sample(P2l, u_r, u_c):
        if u_r.shape != (M,) or u_c.shape != (M,):
            raise ValueError(f"sampler: want {M} row and {M} column uniforms, got "
                             f"{tuple(u_r.shape)} and {tuple(u_c.shape)}")
        # Stage 1: rows from the global row-marginal CDF.
        m = all_gather((P2l.detach() + eps).sum(dim=1), mesh).reshape(R)
        cdf_r = _cumsum(m)
        cdf_r = cdf_r / cdf_r[-1]
        r = torch.searchsorted(cdf_r, u_r.contiguous(), right=True).clamp(0, R - 1)
        # Stage 2: the owning rank contributes each shot's raw row.
        local = (r >= off) & (r < off + Rl)
        rows_l = P2l.index_select(0, (r - off).clamp(0, Rl - 1))
        rows = psum_replicated(torch.where(local[:, None], rows_l, torch.zeros_like(rows_l)),
                               mesh)
        cdf_c = _cumsum(rows.detach() + eps)
        cdf_c = cdf_c / cdf_c[:, -1:]
        c = torch.searchsorted(cdf_c, u_c[:, None].contiguous(), right=True)[:, 0].clamp(0, C - 1)
        q_at = rows.gather(1, c[:, None])[:, 0]
        return r * C + c, q_at

    return sample
