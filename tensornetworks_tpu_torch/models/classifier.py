"""MLP discriminator for adversarial VI.

Counterpart of ``tensornetworks_tpu/models/classifier.py`` (a Flax module):
hidden dims default ``[max(2d, 32), max(d, 16)]``, Linear → optional
BatchNorm → ReLU per hidden layer, one logit out (callers apply the
sigmoid). The parameters are one flat tensor laid out as
``models.born_classical.mlp_layout``; the BatchNorm running statistics are a
second flat tensor (each layer's mean, then its variance), carried by the
caller.

Flax's conventions, kept so that the two packages take the same steps:
- Dense init ``lecun_normal``: a normal truncated to ±2 standard deviations,
  scaled to variance 1/fan_in, and zero biases (torch's ``Linear`` default
  differs);
- BatchNorm: momentum 0.99, eps 1e-5, the **biased** batch variance in both
  the normalisation and the running variance (``nn.BatchNorm1d`` keeps the
  unbiased one), running mean 0 and variance 1 at init.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .born_classical import mlp_layout, split_flat

BATCH_NORM_MOMENTUM = 0.99
BATCH_NORM_EPS = 1e-5
# Standard deviation of a unit normal truncated to [-2, 2]; lecun_normal
# divides by it so that the truncated draw has the variance asked for.
_TRUNC_STD = 0.87962566103423978


class BinaryClassifierMLP:
    def __init__(self, input_dim: int, hidden_dims: Optional[Sequence[int]] = None,
                 use_batch_norm: bool = False, dtype=torch.float32, device="cuda"):
        self.input_dim = input_dim
        if hidden_dims is None:
            hidden_dims = [max(input_dim * 2, 32), max(input_dim, 16)]
        self.hidden_dims = tuple(hidden_dims)
        self.use_batch_norm = use_batch_norm
        self.dtype = dtype
        self.device = torch.device(device)
        self.layout = mlp_layout(input_dim, self.hidden_dims, 1,
                                 "BatchNorm" if use_batch_norm else None)
        self.num_params = sum(math.prod(shape) for _, _, shape in self.layout)
        self.stats_layout = ([(f"BatchNorm_{i}", leaf, (h,)) for i, h in enumerate(self.hidden_dims)
                              for leaf in ("mean", "var")] if use_batch_norm else [])

    def init(self, generator: torch.Generator) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(flat parameters, running statistics or None), drawn on the host."""
        pieces = []
        for _, leaf, shape in self.layout:
            if leaf == "weight":
                w = torch.empty(shape, dtype=torch.float64)
                torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
                pieces.append(w * (math.sqrt(1.0 / shape[1]) / _TRUNC_STD))
            elif leaf == "scale":
                pieces.append(torch.ones(shape, dtype=torch.float64))
            else:
                pieces.append(torch.zeros(shape, dtype=torch.float64))
        params = torch.cat([p.reshape(-1) for p in pieces]).to(device=self.device,
                                                               dtype=self.dtype)
        stats = None
        if self.use_batch_norm:
            stats = torch.cat([torch.zeros(h) if leaf == "mean" else torch.ones(h)
                               for _, leaf, (h,) in self.stats_layout])
            stats = stats.to(device=self.device, dtype=self.dtype)
        return params, stats

    def logits(self, params: torch.Tensor, x: torch.Tensor, stats: Optional[torch.Tensor] = None,
               train: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(B, 1) logits and the running statistics after the call: updated
        from this batch in train mode, unchanged otherwise."""
        v = split_flat(params, self.layout)
        s = split_flat(stats, self.stats_layout) if self.use_batch_norm else None
        new_stats = []
        for i, h in enumerate(self.hidden_dims):
            x = F.linear(x, v[f"Dense_{i}.weight"], v[f"Dense_{i}.bias"])
            if self.use_batch_norm:
                bn = f"BatchNorm_{i}"
                if train:
                    mean = x.mean(dim=0)
                    var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
                    m = BATCH_NORM_MOMENTUM
                    new_stats += [m * s[f"{bn}.mean"] + (1 - m) * mean.detach(),
                                  m * s[f"{bn}.var"] + (1 - m) * var.detach()]
                else:
                    mean, var = s[f"{bn}.mean"], s[f"{bn}.var"]
                x = ((x - mean) * torch.rsqrt(var + BATCH_NORM_EPS) * v[f"{bn}.scale"]
                     + v[f"{bn}.bias"])
            x = torch.relu(x)
        k = len(self.hidden_dims)
        out = F.linear(x, v[f"Dense_{k}.weight"], v[f"Dense_{k}.bias"])
        return out, (torch.cat(new_stats) if new_stats else stats)

    def get_probs(self, params: torch.Tensor, x: torch.Tensor,
                  stats: Optional[torch.Tensor] = None) -> torch.Tensor:
        """P(class 1 | x), in eval mode."""
        return torch.sigmoid(self.logits(params, x, stats)[0])
