"""Categorical sampling over the 2^n outcome space, on the device.

Counterpart of ``tensornetworks_tpu/sim/sampling.py``. Every sampler here
takes its uniforms as an argument (``u``, or ``u_r`` and ``u_c``), so a
caller can replay a given stream; ``draw_uniforms`` draws them from an
explicit ``torch.Generator``. Indices come from the inverse CDF of the
smoothed distribution ``(p + eps) / Σ(p + eps)`` (the reference's +1e-10,
``born_machine_classical_sim.py:105``) by ``searchsorted(..., right=True)``,
clipped to the last outcome.

The JAX ``sample_indices`` takes ``jax.random.categorical`` (Gumbel-max)
below ``CDF_SAMPLING_MIN_SIZE`` outcomes and for batched rows; the port
takes the inverse CDF at every size, which draws the same distribution.

Replay: on CUDA the same inputs give the same shots and gradients on every
run. A CDF whose scan holds all of a tensor's elements is scanned in rows
of ``SCAN_BLOCK`` (``blocked_cumsum``), not by the device-wide scan, whose
float sums depend on how its blocks meet; ``gather_2d`` indexes the flat
view, whose backward (``index_put_`` with accumulation) sorts the indices
and sums each one's cotangents in a fixed order, where
``index_select``/``gather`` would add them by atomics in whatever order the
threads run.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..core.bits import torch_index_to_bits

# The JAX package's switch from Gumbel-max to the inverse CDF (its
# categorical would build (num_samples, 2^n) noise); the port's inverse CDF
# runs at every size, and the constant marks where the two packages draw
# from the same uniforms.
CDF_SAMPLING_MIN_SIZE = 4096


def draw_uniforms(generator: torch.Generator, shape: Union[int, Sequence[int]],
                  dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniforms in [0, 1) of ``shape`` from ``generator`` (on its device
    unless ``device`` is given)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.rand(shape, generator=generator, dtype=dtype,
                      device=generator.device if device is None else device)


# The row length of ``blocked_cumsum``: the row-wise scan takes each row in
# one block, so rows this short keep the scan parallel.
SCAN_BLOCK = 1024


def blocked_cumsum(x: torch.Tensor, block: int = SCAN_BLOCK) -> torch.Tensor:
    """The inclusive prefix sum of a 1-D ``x`` in an order fixed by its
    length: rows of ``block`` elements each scanned by the row-wise scan,
    then the rows' totals scanned the same way (recursively), and each
    row's offset, the sum of the rows before it, added to it. Up to
    ``block`` elements, two copies of x make the rows, so that a single row
    never goes to the device-wide scan."""
    K = x.shape[0]
    if K <= block:
        return torch.stack([x, x]).cumsum(dim=-1)[0]
    rows = -(-K // block)
    if rows * block != K:
        x = torch.cat([x, x.new_zeros(rows * block - K)])
    scan = x.reshape(rows, block).cumsum(dim=-1)
    totals = blocked_cumsum(scan[:, -1].contiguous(), block)
    scan[1:] += totals[:-1, None]
    return scan.reshape(-1)[:K]


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(x, -1)``, the same bits on every run. On CUDA a tensor
    whose last dimension holds all of its elements would go to a
    device-wide scan whose float sums depend on the order its blocks finish
    in; it takes ``blocked_cumsum`` instead. Several rows take the row-wise
    scan kernel, which sums each row in one block in a fixed order. On the
    CPU, torch.cumsum itself."""
    if x.is_cuda and x.numel() == x.shape[-1]:
        return blocked_cumsum(x.reshape(-1)).reshape(x.shape)
    return torch.cumsum(x, dim=-1)


def sample_indices(probs: torch.Tensor, u: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Outcome indices ~ ``probs`` by the inverse CDF. ``probs`` (K,) with
    ``u`` (M,) gives (M,); ``probs`` (B, K), one distribution per row, with
    ``u`` (M, B) gives (M, B), as the JAX package's categorical shape."""
    p = probs + eps
    p = p / p.sum(dim=-1, keepdim=True)
    cdf = _cumsum(p)
    K = probs.shape[-1]
    if probs.ndim == 1:
        idx = torch.searchsorted(cdf, u.contiguous(), right=True)
    else:
        idx = torch.searchsorted(cdf, u.T.contiguous(), right=True).T
    return idx.clamp(0, K - 1)


def sample_bits(probs: torch.Tensor, u: torch.Tensor, num_vars: int,
                dtype=torch.float32) -> torch.Tensor:
    """MSB-first bit rows (..., n) of ``dtype`` sampled from ``probs``."""
    return torch_index_to_bits(sample_indices(probs, u), num_vars, dtype=dtype)


def sample_indices_2d(P: torch.Tensor, u_r: torch.Tensor, u_c: torch.Tensor,
                      eps: float = 1e-10):
    """Exact two-stage sampling of flat indices from an (R, C) probability
    matrix: the row (high bits) from the R-long row-marginal CDF with
    ``u_r``, then the column from the C-long CDFs of only the M gathered
    rows with ``u_c``. The joint is ``(P + eps)[r, c] / Σ(P + eps)``, as
    :func:`sample_indices` on the flat view, but no 2^n-long CDF exists:
    the extra memory is O(2^{n/2} + M·2^{n/2}).

    Returns ``(flat_idx, r, c)`` with ``flat_idx = r·C + c``.
    """
    R, C = P.shape
    Ps = P + eps
    cdf_r = _cumsum(Ps.sum(dim=1))
    cdf_r = cdf_r / cdf_r[-1]
    r = torch.searchsorted(cdf_r, u_r.contiguous(), right=True).clamp(0, R - 1)
    cdf_c = _cumsum(Ps[r])                              # (M, C)
    cdf_c = cdf_c / cdf_c[:, -1:]
    c = torch.searchsorted(cdf_c, u_c[:, None].contiguous(), right=True)[:, 0].clamp(0, C - 1)
    return r * C + c, r, c


def gather_2d(P: torch.Tensor, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``P[r_i, c_i]`` of an (R, C) ``P``, differentiable: the flat view at
    ``r·C + c``, whose backward sums a repeated index's cotangents in a
    fixed order (see the module's note)."""
    return P.reshape(-1)[r * P.shape[1] + c]


def inverse_cdf_sampler(P: torch.Tensor, num_samples: int,
                        generator: Optional[torch.Generator]):
    """The sampled KSD engine's default sampler: ``sample_indices`` on a
    flat (2^n,) distribution, or ``sample_indices_2d`` on its (R, C) view
    (then ``(flat_idx, r, c)``), with uniforms from ``generator``: M for the
    flat case, M for the rows and then M for the columns."""
    if P.ndim == 1:
        return sample_indices(P, draw_uniforms(generator, num_samples, P.dtype, P.device))
    u_r = draw_uniforms(generator, num_samples, P.dtype, P.device)
    u_c = draw_uniforms(generator, num_samples, P.dtype, P.device)
    return sample_indices_2d(P, u_r, u_c)


def step_distances(P: torch.Tensor, idx_a: torch.Tensor, idx_b: torch.Tensor, u: torch.Tensor,
                   u_c: Optional[torch.Tensor] = None, eps: float = 1e-10) -> np.ndarray:
    """Where two draws of flat indices on the same uniforms disagree (two
    evaluations of one sampler in other precisions or summation orders),
    the float64 distance from each such sample's uniform to the nearest
    step of the smoothed CDF between the two indices: a disagreement is a
    rounding tie when it is within the CDF's round-off. ``P`` is the flat
    (K,) distribution with ``u``, or its (R, C) view with the row uniforms
    ``u`` and the column uniforms ``u_c`` (two-stage sampling)."""
    P64 = P.detach().double().cpu().numpy() + eps
    a, b = idx_a.cpu().numpy(), idx_b.cpu().numpy()
    u = u.double().cpu().numpy()
    out = []
    if P64.ndim == 1:
        cdf = np.cumsum(P64) / P64.sum()
        for i in np.flatnonzero(a != b):
            lo, hi = sorted((a[i], b[i]))
            out.append(np.abs(cdf[lo:hi] - u[i]).min())
        return np.asarray(out)
    C = P64.shape[1]
    cdf_r = np.cumsum(P64.sum(axis=1))
    cdf_r /= cdf_r[-1]
    u_c = u_c.double().cpu().numpy()
    for i in np.flatnonzero(a != b):
        (ra, ca), (rb, cb) = divmod(int(a[i]), C), divmod(int(b[i]), C)
        if ra != rb:
            lo, hi = sorted((ra, rb))
            out.append(np.abs(cdf_r[lo:hi] - u[i]).min())
        else:
            row = np.cumsum(P64[ra])
            lo, hi = sorted((ca, cb))
            out.append(np.abs(row[lo:hi] / row[-1] - u_c[i]).min())
    return np.asarray(out)


def parameter_shift_jacobian(probs_fn, params: torch.Tensor) -> torch.Tensor:
    """dp/dθ by the parameter-shift rule for circuits of RX/RY/RZ rotations,
    ``(p(θ + π/2·e_i) - p(θ - π/2·e_i)) / 2``: (2^n, num_params). A
    validation oracle for autograd (the reference's differentiation,
    ``quantum_born_machine.py:58``)."""
    cols = []
    for i in range(params.shape[0]):
        shift = torch.zeros_like(params)
        shift[i] = math.pi / 2
        cols.append((probs_fn(params + shift) - probs_fn(params - shift)) / 2.0)
    return torch.stack(cols, dim=-1)
