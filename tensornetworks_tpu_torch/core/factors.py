"""Factored (CPT-level) Bayesian-network evaluation on batches of
assignments.

Counterpart of ``tensornetworks_tpu/core/factors.py``. The network is
compiled once into padded parent-index, parent-weight and log-CPT tensors,
so ``log p(v)`` of a batch of assignments is a few gathers: O(N) per
assignment and no 2^N table. This is what lets the sampled KSD engine
(``engines/sampled.py``) score samples past exact enumeration.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

from .bayes_net import BayesianNetwork

# Zero CPT entries become log(LOG_FLOOR); sums of N of these stay finite, so
# impossible assignments read as log p ≈ -690·N rather than -inf.
LOG_FLOOR = 1e-300


def compile_factors(bn: BayesianNetwork):
    """The network as dense padded numpy arrays ``(parent_idx,
    parent_weight, log_cpt)``:

    - ``parent_idx`` (N, P) int32: node indices of each node's parents,
      MSB-first, padded with 0 (P = max parent count, at least 1);
    - ``parent_weight`` (N, P) int32: ``2^(P-1-j)`` for real parent slots,
      0 for padding, so ``(assign[parents] * weight).sum()`` is each node's
      MSB-first CPT row;
    - ``log_cpt`` (N, 2^P, 2) float64: ``log p(v_i = b | parents = row)``,
      rows tiled so that padded parent bits are ignored.
    """
    N = bn.num_nodes
    P = max(1, max(len(bn.parents[v]) for v in bn.nodes))
    parent_idx = np.zeros((N, P), dtype=np.int32)
    parent_weight = np.zeros((N, P), dtype=np.int32)
    log_cpt = np.zeros((N, 2**P, 2), dtype=np.float64)
    for i, name in enumerate(bn.nodes):
        ps = [bn.node_to_index[q] for q in bn.parents[name]]
        k = len(ps)
        for j, pp in enumerate(ps):
            parent_idx[i, j] = pp
            parent_weight[i, j] = 1 << (P - 1 - j)
        # Real parents hold the top k bits of the padded row index; tiling
        # over the 2^(P-k) padding bits makes them don't-cares.
        expanded = np.repeat(bn._cpt_arrays[name], 2 ** (P - k), axis=0)
        log_cpt[i] = np.log(np.clip(expanded, LOG_FLOOR, None))
    return parent_idx, parent_weight, log_cpt


def make_log_joint_fn(bn: BayesianNetwork, dtype=torch.float32, device="cuda") -> Callable:
    """``log p(v)`` over batches of full assignments: ``assign`` (..., N)
    of 0/1 entries on ``device`` → (...,) of ``dtype``."""
    parent_idx, parent_weight, log_cpt = compile_factors(bn)
    pi = torch.as_tensor(parent_idx, dtype=torch.int64, device=device)
    pw = torch.as_tensor(parent_weight, dtype=torch.int64, device=device)
    lc = torch.as_tensor(log_cpt, dtype=dtype, device=device)
    nodes = torch.arange(bn.num_nodes, device=device)

    def log_joint(assign: torch.Tensor) -> torch.Tensor:
        a = assign.to(torch.int64)
        rows = (a[..., pi] * pw).sum(dim=-1)     # (..., N)
        return lc[nodes, rows, a].sum(dim=-1)

    return log_joint


def make_latent_log_joint_fn(bn: BayesianNetwork, latent_names: Sequence[str],
                             observed: Dict[str, int], dtype=torch.float32,
                             device="cuda") -> Callable:
    """``log p(x, z)`` as a function of the latent bits only: ``z``
    (..., n) ordered as ``latent_names`` (MSB-first, as
    ``conditional_joint_table``); the observed values are baked in. Every
    node must be latent or observed (others would need marginalising)."""
    names = set(latent_names) | set(observed)
    missing = [v for v in bn.nodes if v not in names]
    if missing:
        raise ValueError(
            f"make_latent_log_joint_fn needs every node latent or observed; "
            f"unassigned: {missing}")
    log_joint = make_log_joint_fn(bn, dtype=dtype, device=device)
    template = torch.zeros(bn.num_nodes, dtype=torch.int64, device=device)
    for v, b in observed.items():
        template[bn.node_to_index[v]] = int(b)
    lat_pos = torch.as_tensor([bn.node_to_index[v] for v in latent_names], dtype=torch.int64,
                              device=device)

    def log_joint_latent(z: torch.Tensor) -> torch.Tensor:
        assign = template.expand(*z.shape[:-1], bn.num_nodes).clone()
        assign[..., lat_pos] = z.to(torch.int64)
        return log_joint(assign)

    return log_joint_latent
