"""Distribution distillation: fit a Born machine directly to a target.

Counterpart of ``tensornetworks_tpu/engines/distill.py``. Two uses:

1. **Warm starts**: pretrain a Born machine toward a cheap surrogate (the
   product of posterior marginals, ``marginals_product``) before a VI
   engine starts from the fitted parameters
   (``runners.scale.run_scale_experiment(warm_start="marginals")``).
2. **Expressivity diagnostics**: fitting a model *directly* to the exact
   posterior separates "the ansatz cannot represent it" from "the VI
   objective does not prefer it"; ``fit_conditioned_born_machine`` does the
   same for one conditioned machine against several posteriors at once.

An epoch is one forward, its loss (``tvd``, ``kl`` = KL(target ‖ q) or
``l2``) and gradient, and the guarded clip → Adam/SGD step on the cosine
schedule of ``engines.common``. The TVD to the target is read from the same
forward as the loss (the pre-update parameters), and the best-TVD
parameters are kept. As in the VI engines the epochs are an eager loop
whose state stays on the device; ``chunk_epochs`` only adds host syncs
(the results are the same).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..models.born_classical import ClassicalBornMachine
from .common import guarded_update, highest_matmul_precision, make_optimizer


def marginals_product(probs, num_vars: int) -> np.ndarray:
    """Product of the single-variable marginals of a 2^n distribution, as a
    normalised float64 (2^n,) array: every first-order marginal exact, and
    representable by shallow circuits."""
    p = np.asarray(probs, dtype=np.float64).reshape((2,) * num_vars)
    out = np.ones((), dtype=np.float64)
    for i in range(num_vars):
        m = p.sum(axis=tuple(j for j in range(num_vars) if j != i))
        out = np.multiply.outer(out, m)
    flat = out.reshape(-1)
    return flat / flat.sum()


def distill_loss(kind: str, q: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The fit loss over the last axis: ``tvd``, ``kl`` (KL(target ‖ q),
    both clamped at 1e-12) or ``l2``."""
    if kind == "tvd":
        return 0.5 * (q - target).abs().sum(dim=-1)
    if kind == "kl":
        return (target * (torch.log(target.clamp(min=1e-12))
                          - torch.log(q.clamp(min=1e-12)))).sum(dim=-1)
    if kind == "l2":
        return ((q - target) ** 2).sum(dim=-1)
    raise ValueError(f"Unknown distill loss {kind!r}; expected tvd|kl|l2")


def batch_probs(born_machine, params: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """(X, 2^n): the distribution for every row of the conditions X. The
    classical machine's MLP takes the batch at once; the quantum machine
    runs one circuit per row on one θ fold (``probs_batch``)."""
    if isinstance(born_machine, ClassicalBornMachine):
        return born_machine.probs(params, X)
    return born_machine.probs_batch(params, X)


def _fit(born_machine, probs_fn, target, *, num_epochs, lr, loss, optimizer_type,
         use_lr_scheduler, gradient_clip_norm, params0, seed, chunk_epochs):
    """The shared epoch loop: returns (best params, loss history, TVD
    history, best TVD, best epoch). ``probs_fn(p)`` gives (..., 2^n) rows
    matching ``target``; loss and TVD are means over the rows."""
    params = (born_machine.init(torch.Generator().manual_seed(seed)) if params0 is None
              else torch.as_tensor(params0, dtype=born_machine.dtype,
                                   device=born_machine.device).detach().clone())
    optimizer = make_optimizer(optimizer_type, lr, num_epochs, use_lr_scheduler, (0.9, 0.999),
                               gradient_clip_norm)
    opt_state = optimizer.init(params)
    dev = params.device
    hist = torch.full((2, num_epochs), float("nan"), dtype=params.dtype, device=dev)
    best_tvd = torch.tensor(float("inf"), dtype=params.dtype, device=dev)
    best_epoch = torch.zeros((), dtype=torch.int64, device=dev)
    best_params = params.clone()
    chunk = chunk_epochs or num_epochs
    for start in range(0, num_epochs, chunk):
        for epoch in range(start, min(start + chunk, num_epochs)):
            p = params.detach().requires_grad_(True)
            q = probs_fn(p)
            loss_v = distill_loss(loss, q, target).mean()
            (grads,) = torch.autograd.grad(loss_v, p)
            tvd = (0.5 * (q.detach() - target).abs().sum(dim=-1)).mean()
            improved = tvd < best_tvd
            best_tvd = torch.where(improved, tvd, best_tvd)
            best_epoch = torch.where(improved, torch.full_like(best_epoch, epoch), best_epoch)
            best_params = torch.where(improved, params, best_params)
            params, opt_state = guarded_update(optimizer, grads, opt_state, params,
                                               torch.isfinite(loss_v))
            hist[:, epoch] = torch.stack([loss_v.detach(), tvd])
        best_tvd.item()  # host sync closes the chunk
    hist = hist.cpu().numpy()
    return best_params, hist[0], hist[1], float(best_tvd), int(best_epoch)


@highest_matmul_precision()
def fit_born_machine(born_machine, target_probs, *, num_epochs: int = 1000, lr: float = 0.05,
                     loss: str = "tvd", optimizer_type: str = "adam",
                     use_lr_scheduler: bool = True, gradient_clip_norm: float = 10.0,
                     params0=None, x_condition=None, seed: int = 0,
                     chunk_epochs: Optional[int] = None):
    """Fit ``born_machine`` (classical or quantum; ``x_condition`` for a
    conditioned one) so that its distribution matches ``target_probs``,
    from ``params0`` or its ``init`` drawn from ``seed``.

    Returns ``(best_params, history)``: ``loss`` and ``tvd`` per epoch (the
    TVD to the target whatever the fit loss, on the pre-update parameters),
    ``best_tvd``, ``best_epoch`` and ``train_seconds``."""
    target = torch.as_tensor(np.asarray(target_probs), dtype=born_machine.dtype,
                             device=born_machine.device)

    def probs_fn(p):
        if x_condition is not None:
            return born_machine.probs(p, x_condition)
        return born_machine.probs(p)

    t0 = time.perf_counter()
    best_params, losses, tvds, best_tvd, best_epoch = _fit(
        born_machine, probs_fn, target, num_epochs=num_epochs, lr=lr, loss=loss,
        optimizer_type=optimizer_type, use_lr_scheduler=use_lr_scheduler,
        gradient_clip_norm=gradient_clip_norm, params0=params0, seed=seed,
        chunk_epochs=chunk_epochs)
    return best_params, {"loss": losses, "tvd": tvds, "best_tvd": best_tvd,
                         "best_epoch": best_epoch, "train_seconds": time.perf_counter() - t0}


@highest_matmul_precision()
def fit_conditioned_born_machine(born_machine, targets, x_conditions, *,
                                 num_epochs: int = 1000, lr: float = 0.05, loss: str = "tvd",
                                 optimizer_type: str = "adam", use_lr_scheduler: bool = True,
                                 gradient_clip_norm: float = 10.0, params0=None, seed: int = 0,
                                 chunk_epochs: Optional[int] = None):
    """One conditioned Born machine fitted to a batch of targets at once
    (loss = mean over the observations): the amortized expressivity
    diagnostic. ``targets`` (X, 2^n), ``x_conditions`` (X, d), one row per
    target. Returns ``(best_params, history)`` with ``loss``, ``mean_tvd``
    per epoch, ``best_mean_tvd`` and ``best_epoch``."""
    T = torch.as_tensor(np.asarray(targets), dtype=born_machine.dtype,
                        device=born_machine.device)
    X = torch.as_tensor(np.asarray(x_conditions), dtype=born_machine.dtype,
                        device=born_machine.device)
    if T.dim() != 2 or X.shape[0] != T.shape[0]:
        raise ValueError(f"targets {tuple(T.shape)} / x_conditions {tuple(X.shape)} must "
                         "share a leading observation axis")
    t0 = time.perf_counter()
    best_params, losses, tvds, best_tvd, best_epoch = _fit(
        born_machine, lambda p: batch_probs(born_machine, p, X), T, num_epochs=num_epochs,
        lr=lr, loss=loss, optimizer_type=optimizer_type, use_lr_scheduler=use_lr_scheduler,
        gradient_clip_norm=gradient_clip_norm, params0=params0, seed=seed,
        chunk_epochs=chunk_epochs)
    return best_params, {"loss": losses, "mean_tvd": tvds, "best_mean_tvd": best_tvd,
                         "best_epoch": best_epoch, "train_seconds": time.perf_counter() - t0}
