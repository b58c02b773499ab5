"""Plain float64 pieces of the sampled (U-statistic) KSD step, on q held
in blocks (``circuit.py``: D blocks of consecutive states, block b on the
b-th device; the shots, the uniforms and the Gram live on the first
block's device).

- ``two_stage_draws``: the shots the inverse CDF gives for uniforms
  (u_r, u_c) on the smoothed distribution (q + eps) / sum(q + eps) viewed
  as (R, C), R = 2^ceil(n/2): the row by the row marginals' CDF, then the
  column by that row's CDF, each the first step strictly above the
  uniform. Each block gives the marginals of its R/D rows, and only the M
  drawn rows are read whole.
- ``ustat``: the mean of the off-diagonal Gram entries.
- ``surrogate_cotangent``: dL/dq, as blocks, of the REINFORCE surrogate
  (2/M) sum_i (w_i - b_i) log q(z_i), w_i the mean of row i's off-diagonal
  Gram entries and b_i the leave-one-out baseline, the mean over the
  off-diagonal pairs without sample i; log q is floored at ``LOG_FLOOR``,
  below which it has no gradient.
- ``Loss``: the U-statistic loss of one step on the shots the program
  drew, with the draws worked out again from the same uniforms; it counts
  the shots that differ (``shots_mismatch``).
"""

from __future__ import annotations

from typing import List

import torch

from .stein import gram

CDF_EPS = 1e-10
LOG_FLOOR = 1e-12


def _rows(q: List[torch.Tensor], n: int):
    """(R, C, rows a block, each block viewed as its (R/D, C) rows)."""
    rb = (n + 1) // 2
    R, C = 1 << rb, 1 << (n - rb)
    if R % len(q):
        raise ValueError(f"{len(q)} blocks do not split {R} rows")
    Rl = R // len(q)
    return R, C, Rl, [x.view(Rl, C) for x in q]


def at_shots(q: List[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    """q at the flat indices ``idx``, on idx's device."""
    size = q[0].numel()
    out = torch.empty(idx.shape, dtype=q[0].dtype, device=idx.device)
    for b, x in enumerate(q):
        sel = (idx // size) == b
        out[sel] = x[(idx[sel] - b * size).to(x.device)].to(idx.device)
    return out


def two_stage_draws(q: List[torch.Tensor], u_r: torch.Tensor, u_c: torch.Tensor,
                    n: int) -> torch.Tensor:
    R, C, Rl, P = _rows(q, n)
    dev = u_r.device
    cdf_r = torch.cumsum(torch.cat([(p + CDF_EPS).sum(dim=1).to(dev) for p in P]), 0)
    cdf_r = cdf_r / cdf_r[-1]
    r = torch.searchsorted(cdf_r, u_r.to(torch.float64), right=True).clamp(0, R - 1)
    rows = torch.empty((r.numel(), C), dtype=q[0].dtype, device=dev)
    for b, p in enumerate(P):
        sel = (r // Rl) == b
        rows[sel] = (p[(r[sel] - b * Rl).to(p.device)] + CDF_EPS).to(dev)
    cdf_c = torch.cumsum(rows, 1)
    cdf_c = cdf_c / cdf_c[:, -1:]
    c = torch.searchsorted(cdf_c, u_c.to(torch.float64)[:, None], right=True)[:, 0]
    return r * C + c.clamp(0, C - 1)


def ustat(G: torch.Tensor) -> torch.Tensor:
    M = G.shape[0]
    return (G.sum() - torch.trace(G)) / (M * (M - 1))


def surrogate_cotangent(G: torch.Tensor, idx: torch.Tensor,
                        q: List[torch.Tensor]) -> List[torch.Tensor]:
    """dL/dq of the surrogate at the shots ``idx`` (M,), as q's blocks."""
    M = G.shape[0]
    row = G.sum(dim=1) - torch.diagonal(G)
    coef = 2.0 / M * (row / (M - 1) - (row.sum() - 2.0 * row) / ((M - 1) * (M - 2)))
    qi = at_shots(q, idx)
    coef = torch.where(qi > LOG_FLOOR, coef / qi, torch.zeros_like(coef))
    size = q[0].numel()
    out = []
    for b, x in enumerate(q):
        sel = (idx // size) == b
        out.append(torch.zeros_like(x).index_add_(0, (idx[sel] - b * size).to(x.device),
                                                  coef[sel].to(x.device)))
    return out


class Loss:
    def __init__(self, problem: dict, record: dict, net, device):
        self.n, self.length_scale = problem["n"], problem["length_scale"]
        self.num_samples, self.record, self.net = problem["num_samples"], record, net
        self.device = device
        self.mismatch = 0

    def __call__(self, k: int, q: List[torch.Tensor]):
        """(loss, dL/dq as q's blocks) of step ``k`` at the reference's q."""
        n, M, dev = self.n, self.num_samples, self.device
        gen = torch.Generator(device=dev)
        gen.set_state(self.record["gen_states"][k])
        u_r = torch.rand(M, generator=gen, dtype=torch.float32, device=dev)
        u_c = torch.rand(M, generator=gen, dtype=torch.float32, device=dev)
        shots = torch.as_tensor(self.record["shots"][k], dtype=torch.int64, device=dev)
        self.mismatch += int((two_stage_draws(q, u_r, u_c, n) != shots).sum())
        Z = (shots[:, None] >> torch.arange(n - 1, -1, -1, device=dev)) & 1
        lp = self.net.log_joint(shots)
        S = torch.stack([self.net.score(shots, m, lp) for m in range(n)], dim=1)
        G = gram(S, Z, n, self.length_scale)
        return float(ustat(G)), surrogate_cotangent(G, shots, q)

    def numbers(self) -> dict:
        return {"shots_mismatch": float(self.mismatch)}
