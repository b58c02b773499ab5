"""Classical Born machine: a softmax table or a conditional MLP over 2^n
outcomes.

Counterpart of ``tensornetworks_tpu/models/born_classical.py``. The
parameters are one flat tensor; ``views`` reads the named pieces out of it
(``layout``), so the optimizer steps one vector as it does for the quantum
Born machine.

- unconditional: a ``2^n`` logits table with init ``zero | small_random
  (0.1·N(0,1)) | uniform (log(1/2^n) + 0.01·N(0,1)) | random (N(0,1))``;
- conditional: an MLP ``x → 2^n`` logits (hidden dims default
  ``[max(4d, 64), max(2d, 32)]``; Linear → optional LayerNorm → ReLU →
  Dropout per hidden layer), Xavier-uniform weights and zero biases, as
  the JAX model's Flax ``_CondNet``. The weights are kept as torch's
  (out, in), the transpose of a Flax kernel (``interop.flat_from_flax``),
  and LayerNorm takes Flax's eps of 1e-6 (torch's default is 1e-5).

Raw outputs map to probabilities by ``softmax`` or, with
``use_logits=False``, by ``|raw| / Σ|raw|``. Fixed-probs mode freezes an
explicit distribution for evaluation after training. ``log_q`` reads
log q at sampled bit rows by a gather; ``sample`` draws bit rows by the
inverse CDF (``sim/sampling.py``), one distribution per condition row.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..core.bits import generate_all_binary_outcomes, torch_bits_to_index
from ..sim.sampling import draw_uniforms, sample_bits

PROB_EPS = 1e-10
LAYER_NORM_EPS = 1e-6


def split_flat(params: torch.Tensor, layout) -> dict:
    """Views of a flat parameter vector by ``layout``, a list of
    ``(module, leaf, shape)``; keys are ``module`` or ``module.leaf``."""
    out, start = {}, 0
    for module, leaf, shape in layout:
        size = math.prod(shape)
        key = module if leaf is None else f"{module}.{leaf}"
        out[key] = params[start:start + size].view(shape)
        start += size
    return out


def mlp_layout(input_dim: int, hidden_dims: Sequence[int], output_dim: int, norm: Optional[str]):
    """Layout of an MLP's flat parameters, named as its Flax counterpart's
    modules (``Dense_i``, and ``LayerNorm_i`` or ``BatchNorm_i``)."""
    layout, width = [], input_dim
    for i, h in enumerate(hidden_dims):
        layout += [(f"Dense_{i}", "weight", (h, width)), (f"Dense_{i}", "bias", (h,))]
        if norm is not None:
            layout += [(f"{norm}_{i}", "scale", (h,)), (f"{norm}_{i}", "bias", (h,))]
        width = h
    k = len(hidden_dims)
    return layout + [(f"Dense_{k}", "weight", (output_dim, width)),
                     (f"Dense_{k}", "bias", (output_dim,))]


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Flax's inverted dropout: keep with probability 1 - rate, rescaled by
    1/(1 - rate); the mask is drawn from ``generator``."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, dtype=x.dtype, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class ClassicalBornMachine:
    def __init__(self, num_latent_vars: int, use_logits: bool = True,
                 conditioning_dim: int = 0, init_method: str = "small_random",
                 hidden_dims: Optional[Sequence[int]] = None,
                 use_layer_norm: bool = False, dropout_rate: float = 0.1,
                 dtype=torch.float32, device="cuda"):
        self.num_latent_vars = num_latent_vars
        self.num_outcomes = 2**num_latent_vars
        self.use_logits = use_logits
        self.conditioning_dim = conditioning_dim
        self.init_method = init_method
        self.use_layer_norm = use_layer_norm
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.device = torch.device(device)
        self._fixed_probs = None
        self._all_outcome_tuples = None
        if conditioning_dim > 0:
            if hidden_dims is None:
                hidden_dims = [max(conditioning_dim * 4, 64), max(conditioning_dim * 2, 32)]
            self.hidden_dims = tuple(hidden_dims)
            self.layout = mlp_layout(conditioning_dim, self.hidden_dims, self.num_outcomes,
                                     "LayerNorm" if use_layer_norm else None)
        else:
            self.hidden_dims = None
            self.layout = [("table", None, (self.num_outcomes,))]
        self.num_params = sum(math.prod(shape) for _, _, shape in self.layout)

    # ---------------------------------------------------------------- params

    def views(self, params: torch.Tensor) -> dict:
        return split_flat(params, self.layout)

    def init(self, generator: torch.Generator) -> torch.Tensor:
        """Initial flat parameters, drawn on the host from ``generator``."""
        g, N = generator, self.num_outcomes
        f64 = dict(dtype=torch.float64)
        if self.conditioning_dim > 0:
            pieces = []
            for _, leaf, shape in self.layout:
                if leaf == "weight":  # Xavier uniform: U(±sqrt(6 / (fan_in + fan_out)))
                    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
                    pieces.append(limit * (2.0 * torch.rand(shape, generator=g, **f64) - 1.0))
                elif leaf == "scale":
                    pieces.append(torch.ones(shape, **f64))
                else:
                    pieces.append(torch.zeros(shape, **f64))
            flat = torch.cat([p.reshape(-1) for p in pieces])
        elif self.init_method == "zero":
            flat = torch.zeros(N, **f64)
        elif self.init_method == "small_random":
            flat = 0.1 * torch.randn(N, generator=g, **f64)
        elif self.init_method == "uniform":
            flat = math.log(1.0 / N) + 0.01 * torch.randn(N, generator=g, **f64)
        else:  # 'random'
            flat = torch.randn(N, generator=g, **f64)
        return flat.to(device=self.device, dtype=self.dtype)

    # ----------------------------------------------------- fixed-probs mode

    def set_fixed_probs(self, probs: torch.Tensor):
        self._fixed_probs = probs.detach()

    def clear_fixed_probs(self):
        self._fixed_probs = None

    # ----------------------------------------------------------------- probs

    def probs(self, params: torch.Tensor, x_condition=None, *, train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Distribution over all 2^n outcomes: (2^n,) for one condition (or
        none), (B, 2^n) for a batch. ``train`` applies dropout with masks
        drawn from ``generator``."""
        if self._fixed_probs is not None:
            return self._fixed_probs
        if self.conditioning_dim == 0:
            if x_condition is not None:
                raise ValueError("x_condition provided but conditioning_dim is 0.")
            return self._normalize(params)
        if x_condition is None:
            raise ValueError("x_condition must be provided for conditional Born machine.")
        x = torch.as_tensor(x_condition, dtype=self.dtype, device=params.device)
        squeeze = x.ndim == 1
        raw = self._mlp(params, x[None, :] if squeeze else x, train, generator)
        out = self._normalize(raw)
        return out[0] if squeeze else out

    def _mlp(self, params, x, train, generator):
        v = self.views(params)
        rate = self.dropout_rate if train else 0.0
        if rate > 0.0 and generator is None:
            raise ValueError("train=True with dropout needs a generator")
        for i, h in enumerate(self.hidden_dims):
            x = F.linear(x, v[f"Dense_{i}.weight"], v[f"Dense_{i}.bias"])
            if self.use_layer_norm:
                x = F.layer_norm(x, (h,), v[f"LayerNorm_{i}.scale"], v[f"LayerNorm_{i}.bias"],
                                 eps=LAYER_NORM_EPS)
            x = dropout(torch.relu(x), rate, generator)
        k = len(self.hidden_dims)
        return F.linear(x, v[f"Dense_{k}.weight"], v[f"Dense_{k}.bias"])

    def _normalize(self, raw: torch.Tensor) -> torch.Tensor:
        if self.use_logits:
            return torch.softmax(raw, dim=-1)
        p = raw.abs()
        return p / p.sum(dim=-1, keepdim=True)

    # ----------------------------------------------------------- derived ops

    def log_probs(self, params, x_condition=None, **kw) -> torch.Tensor:
        return torch.log(self.probs(params, x_condition, **kw).clamp(min=PROB_EPS))

    def log_q(self, params, z_samples, x_condition=None, **kw) -> torch.Tensor:
        """log q(z|x) per sample row: a gather in the (2^n,) log table, or
        for a batch of conditions (B, 2^n) row i's entry at z_samples[i]."""
        lp = self.log_probs(params, x_condition, **kw)
        idx = torch_bits_to_index(z_samples)
        if lp.ndim == 1:
            return lp[idx]
        return lp.gather(-1, idx[:, None])[:, 0]

    def sample(self, generator: torch.Generator, params, num_samples: int, x_condition=None,
               train: bool = False) -> torch.Tensor:
        """(num_samples, n) float32 bit rows, or (num_samples, B, n) for a
        batch of B conditions, with uniforms (after any dropout masks, with
        ``train``) from ``generator``."""
        p = self.probs(params, x_condition, train=train, generator=generator)
        shape = (num_samples,) + tuple(p.shape[:-1])
        return sample_bits(p, draw_uniforms(generator, shape, p.dtype, p.device),
                           self.num_latent_vars)

    def entropy(self, params, x_condition=None, **kw) -> torch.Tensor:
        p = self.probs(params, x_condition, **kw)
        return -(p * torch.log(p.clamp(min=PROB_EPS))).sum(dim=-1)

    def get_prob_dict(self, params, x_condition=None) -> dict:
        with torch.no_grad():
            p = self.probs(params, x_condition).detach().cpu().numpy()
        if self._all_outcome_tuples is None:
            self._all_outcome_tuples = generate_all_binary_outcomes(self.num_latent_vars)
        return {t: float(p[i]) for i, t in enumerate(self._all_outcome_tuples)}
