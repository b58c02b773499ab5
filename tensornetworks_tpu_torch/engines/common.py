"""Shared training scaffolding: cosine schedule, clip-then-Adam/SGD, the
guarded update and the global gradient norm.

Counterpart of ``tensornetworks_tpu/engines/common.py``, with optax's
semantics written out in torch so that both packages take the same steps:
clip by global norm (``g · max/‖g‖`` when ‖g‖ ≥ max), Adam with bias
correction and eps=1e-8 (or SGD with momentum 0.9), and a learning rate
from a cosine schedule that decays to lr/10 and advances once per epoch.
Every parameter set is one flat tensor: optax on a pytree is elementwise
apart from the global norm, and the global norm of the leaves is the norm
of the flat vector, so the steps are the same. The optimizer is functional:
``update`` returns new parameters and state, and ``guarded_update`` keeps
the old ones on a step whose loss is not finite, so a skipped step moves
neither the moments nor the step count (hence not the schedule either).
Everything stays on the device: no host sync per step.

``highest_matmul_precision`` is the training context of the JAX package's
matmul precision (``TNTPU_MATMUL_PRECISION``); every engine's ``train``
runs inside it.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..ops.kernels.precision import precision_name
from ..train import span


def cosine_lr_schedule(lr: float, num_epochs: int, steps_per_epoch: int = 1) -> Callable:
    """CosineAnnealingLR semantics indexed by epoch: ``count`` (a tensor of
    updates taken) maps to ``epoch = min(count // steps_per_epoch, T)`` (an
    optimizer stepped k times per epoch still advances the schedule once
    per epoch) and ``lr_t = eta_min + (lr - eta_min)(1 + cos(π·epoch/T)) / 2``
    with ``eta_min = lr/10``."""
    eta_min = 0.1 * lr

    def schedule(count: torch.Tensor) -> torch.Tensor:
        if steps_per_epoch != 1:  # no extra launch on the one-step-per-epoch paths
            count = count // steps_per_epoch
        epoch = torch.clamp(count, max=num_epochs).to(torch.float64)
        return eta_min + (lr - eta_min) * 0.5 * (1.0 + torch.cos(math.pi * epoch / num_epochs))

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm over a list of gradient tensors."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


class Optimizer:
    """clip-by-global-norm → adam | sgd(momentum 0.9), on one flat tensor."""

    def __init__(self, optimizer_type: str, lr: float, num_epochs: int,
                 use_lr_scheduler: bool = True, adam_betas: Tuple[float, float] = (0.9, 0.999),
                 gradient_clip_norm: Optional[float] = 10.0, steps_per_epoch: int = 1):
        self.kind = "sgd" if optimizer_type == "sgd" else "adam"
        # An unknown optimizer name is Adam with its default betas.
        self.betas = adam_betas if optimizer_type == "adam" else (0.9, 0.999)
        self.lr = (cosine_lr_schedule(lr, num_epochs, steps_per_epoch)
                   if use_lr_scheduler else (lambda count: lr))
        self.clip = gradient_clip_norm
        self.eps = 1e-8

    def init(self, params: torch.Tensor) -> Dict[str, torch.Tensor]:
        state = {"count": torch.zeros((), dtype=torch.int64, device=params.device)}
        if self.kind == "adam":
            state["mu"] = torch.zeros_like(params)
            state["nu"] = torch.zeros_like(params)
        else:
            state["trace"] = torch.zeros_like(params)
        return state

    def update(self, grads: torch.Tensor, state: Dict[str, torch.Tensor],
               params: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if self.clip is not None:
            g_norm = global_norm([grads])
            grads = torch.where(g_norm < self.clip, grads, grads / g_norm * self.clip)
        count = state["count"]
        lr = self.lr(count)
        new = {"count": count + 1}
        if self.kind == "adam":
            b1, b2 = self.betas
            mu = (1 - b1) * grads + b1 * state["mu"]
            nu = (1 - b2) * grads * grads + b2 * state["nu"]
            t = new["count"].to(grads.dtype)
            step = (mu / (1 - b1**t)) / (torch.sqrt(nu / (1 - b2**t)) + self.eps)
            new["mu"], new["nu"] = mu, nu
        else:
            step = grads + 0.9 * state["trace"]
            new["trace"] = step
        return params - lr * step, new


def make_optimizer(optimizer_type: str, lr: float, num_epochs: int,
                   use_lr_scheduler: bool = True, adam_betas: Tuple[float, float] = (0.9, 0.999),
                   gradient_clip_norm: Optional[float] = 10.0,
                   steps_per_epoch: int = 1) -> Optimizer:
    return Optimizer(optimizer_type, lr, num_epochs, use_lr_scheduler, adam_betas,
                     gradient_clip_norm, steps_per_epoch)


def guarded_update(opt: Optimizer, grads: torch.Tensor, state: Dict[str, torch.Tensor],
                   params: torch.Tensor, apply: torch.Tensor):
    """The optimizer step where ``apply`` (a bool tensor) is true; otherwise
    params and every state entry, the step count included, stay as they were."""
    with span("engine.update"):
        new_params, new_state = opt.update(grads, state, params)
        return (torch.where(apply, new_params, params),
                {k: torch.where(apply, new_state[k], state[k]) for k in state})


# The cuBLAS/cuDNN mode of each matmul precision name: ``allow_tf32``. TF32
# keeps 10 mantissa bits and three bf16 passes about 16, so no cuBLAS mode
# reachable from torch is as precise as ``high`` and cheaper than FP32:
# ``high`` and ``highest`` run FP32, ``default`` (one bf16 pass, 8 bits) TF32,
# the cheapest mode at least as precise.
MATMUL_TF32 = {"highest": False, "high": False, "default": True}


@contextlib.contextmanager
def highest_matmul_precision():
    """Training context: the precision of torch's float32 matmuls outside
    the kernels (the θ fold, the MLPs, the blocked executor, the dense
    Gram), from ``TNTPU_MATMUL_PRECISION`` read on entry (``default``,
    ``high`` or ``highest``, case-insensitive; default ``high``; an unknown
    name raises ``KeyError``). Sets ``torch.backends.cuda.matmul.allow_tf32``
    and cuDNN's by ``MATMUL_TF32``, restores both on exit. Usable as a
    decorator. The JAX package measured one bf16 pass (its ``default``) to
    cost 16-24x in final TVD and three (``high``) to match ``highest``; the
    name is the JAX function's. The circuit kernels' precision is the other
    knob, ``ops.kernels.precision``."""
    tf32 = MATMUL_TF32[precision_name(os.environ.get("TNTPU_MATMUL_PRECISION", "high"))]
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
