"""The exact KSD loss of one step in float64: sqrt(q^T K_p q) over all
2^n states, with K_p q from ``stein.exact_matvec``, and its cotangent
dL/dq = K_p q / L (K_p is symmetric). A quadratic form under
``QUAD_FLOOR`` gives the floor's root and no gradient. The Stein form
takes all 2^n states on one device: q comes in one block (D = 1).
"""

from __future__ import annotations

import numpy as np
import torch

from .stein import exact_matvec

QUAD_FLOOR = 1e-12


class Loss:
    def __init__(self, problem: dict, record: dict, net, device):
        self.n, self.length_scale, self.net = problem["n"], problem["length_scale"], net
        self.idx = torch.arange(1 << self.n, dtype=torch.int64, device=device)
        self.log_p = net.log_joint(self.idx)

    def __call__(self, k: int, blocks):
        """(loss, [dL/dq]) of step ``k`` at the reference's q, one block."""
        if len(blocks) != 1:
            raise ValueError(f"the exact Stein form runs on one block, not {len(blocks)}")
        (q,) = blocks
        y = exact_matvec(q, lambda m: self.net.score(self.idx, m, self.log_p), self.n,
                         self.length_scale)
        quad = float(torch.dot(q, y))
        loss = float(np.sqrt(max(quad, QUAD_FLOOR)))
        return loss, [y / loss if quad > QUAD_FLOOR else torch.zeros_like(y)]

    def numbers(self) -> dict:
        return {}
