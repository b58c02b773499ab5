"""Plain float64 log joint and discrete score of a binary Bayesian network.

The network is given as arrays: ``parents[i]`` lists node i's parent
nodes, ``cpts[i]`` is its (2^k, 2) table p(v_i | parents) with the row
index the parents' values MSB-first in the listed order. The first
``num_latent`` nodes are the latent variables (latent j is bit n-1-j of a
state index, qubit 0 the most significant); ``observed`` maps the other
nodes to their values.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

# The score's zero-probability guard: states with p(x, z) below it score 0.
SCORE_EPS = 1e-12


class Network:
    def __init__(self, parents: Sequence[Sequence[int]], cpts: Sequence[np.ndarray],
                 num_latent: int, observed: Dict[int, int], device="cpu"):
        self.parents = [list(map(int, p)) for p in parents]
        self.n = num_latent
        self.observed = {int(k): int(v) for k, v in observed.items()}
        self.device = torch.device(device)
        self.log_cpts = [torch.as_tensor(np.log(np.asarray(c, dtype=np.float64)),
                                         device=self.device) for c in cpts]

    def log_joint(self, idx: torch.Tensor) -> torch.Tensor:
        """log p(x, z) (float64) of latent state indices ``idx`` (int64)."""
        n = self.n
        vals = {}
        for i in range(len(self.parents)):
            if i < n:
                vals[i] = (idx >> (n - 1 - i)) & 1
            else:
                vals[i] = torch.full_like(idx, self.observed[i])
        out = torch.zeros(idx.shape, dtype=torch.float64, device=idx.device)
        for i, ps in enumerate(self.parents):
            row = torch.zeros_like(idx)
            for j, p in enumerate(ps):
                row = row + (vals[p] << (len(ps) - 1 - j))
            out = out + self.log_cpts[i][row, vals[i]]
        return out

    def score(self, idx: torch.Tensor, m: int, log_p: torch.Tensor = None) -> torch.Tensor:
        """s_m(z) = 1 - p(x, flip_m z) / p(x, z) at ``idx``, 0 where
        p(x, z) < SCORE_EPS."""
        lp = self.log_joint(idx) if log_p is None else log_p
        s = 1.0 - torch.exp(self.log_joint(idx ^ (1 << (self.n - 1 - m))) - lp)
        return torch.where(lp < math.log(SCORE_EPS), torch.zeros_like(s), s)
