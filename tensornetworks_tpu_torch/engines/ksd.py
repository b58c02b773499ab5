"""Exact KSD variational inference with a quantum Born machine.

Counterpart of ``run_ksd_scan`` and ``QuantumKSDVariationalInference`` in
``tensornetworks_tpu/engines/ksd.py``. The JAX engine runs the epochs as one
``lax.scan``; here they are an eager loop whose per-epoch state (parameters,
optimizer moments, best snapshot, history) stays on the device, so the host
waits for the device only at chunk ends.

Per epoch: ``loss = sqrt(clamp(qᵀ K_p q, 1e-12))``, its gradient, clip →
Adam/SGD with the per-epoch cosine schedule, a guarded update that skips a
non-finite loss together with its schedule step, and the TVD to the exact
posterior with a best-TVD snapshot that is restored at the end.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.bayes_net import BayesianNetwork
from ..core.bits import generate_all_binary_outcomes
from ..models.born_quantum import QuantumBornMachine
from ..ops.hamming import resolve_length_scale
from ..ops.stein import SteinOperator, score_table
from ..sim.structured import latent_edges
from .common import global_norm, guarded_update, make_optimizer


def _posterior_vec_from(true_posterior, num_latent_vars, dtype, device):
    """Accept the dict format or a dense vector."""
    if true_posterior is None:
        return None
    if isinstance(true_posterior, dict):
        outcomes = generate_all_binary_outcomes(num_latent_vars)
        vec = np.array([true_posterior.get(t, 0.0) for t in outcomes])
    else:
        vec = np.asarray(true_posterior)
    return torch.as_tensor(vec, dtype=dtype, device=device)


def run_ksd_scan(*, probs_fn, params0: torch.Tensor, op: SteinOperator, num_epochs: int,
                 optimizer, posterior_vec: Optional[torch.Tensor],
                 chunk_epochs: Optional[int] = None) -> dict:
    """Train for ``num_epochs``; returns final/best params and the history.

    The TVD evaluation reuses the loss forward (the JAX engine's
    ``reuse_loss_forward_for_eval``): ``probs_fn`` is deterministic, so epoch
    t's post-update distribution is epoch t+1's loss forward, and one extra
    forward after the loop covers the last epoch. The recorded TVD history
    and the best snapshot are those of evaluating after every update.

    ``chunk_epochs``: split the loop into chunks with a host sync after each
    (per-chunk wall times go to ``chunk_seconds``); the results are the same.
    """
    dev = params0.device
    params = params0.detach().clone()
    opt_state = optimizer.init(params)
    track = posterior_vec is not None
    hist = torch.full((4, num_epochs), float("nan"), dtype=params.dtype, device=dev)
    best_tvd = torch.tensor(float("inf"), dtype=params.dtype, device=dev)
    best_epoch = torch.tensor(-1, dtype=torch.int64, device=dev)
    best_params = params.clone()

    def take_best(tvd, epoch, candidate):
        nonlocal best_tvd, best_epoch, best_params
        improved = tvd < best_tvd
        best_tvd = torch.where(improved, tvd, best_tvd)
        best_epoch = torch.where(improved, torch.full_like(best_epoch, epoch), best_epoch)
        best_params = torch.where(improved, candidate, best_params)

    chunk = chunk_epochs or num_epochs
    chunk_seconds = []
    for start in range(0, num_epochs, chunk):
        t_chunk = time.perf_counter()
        for epoch in range(start, min(start + chunk, num_epochs)):
            p = params.detach().requires_grad_(True)
            q = probs_fn(p)
            ksd = op.ksd_loss(q)
            (grads,) = torch.autograd.grad(ksd, p)
            do_update = torch.isfinite(ksd)
            tvd = torch.full_like(ksd, float("nan"))
            if track:
                # q at the current params is the previous epoch's post-update
                # distribution; epoch 0's is the init, not a candidate.
                tvd = 0.5 * (q.detach() - posterior_vec).abs().sum()
                if epoch > 0:
                    take_best(tvd, epoch - 1, params)
            params, opt_state = guarded_update(optimizer, grads, opt_state, params, do_update)
            hist[:, epoch] = torch.stack([ksd.detach(), tvd, global_norm([grads]),
                                          (~do_update).to(hist.dtype)])
        best_tvd.item()  # host sync closes the chunk
        chunk_seconds.append((min(chunk, num_epochs - start), time.perf_counter() - t_chunk))

    with torch.no_grad():
        if track:
            # The last epoch's post-update evaluation; shift the history so
            # hist[t] is epoch t's post-update TVD.
            tvd_last = 0.5 * (probs_fn(params) - posterior_vec).abs().sum()
            take_best(tvd_last, num_epochs - 1, params)
            hist[1] = torch.cat([hist[1, 1:], tvd_last[None]])
        best_probs = probs_fn(best_params)
    ksd_h, tvd_h, gnorm_h, skipped_h = hist.cpu().numpy()
    return {
        "params": params,
        "best_tvd": float(best_tvd),
        "best_epoch": int(best_epoch),
        "best_params": best_params,
        "best_probs": best_probs,
        "loss_ksd": ksd_h,
        "tvd": tvd_h,
        "grad_norm": gnorm_h,
        "skipped": skipped_h,
        "chunk_seconds": chunk_seconds,
    }


def steady_epochs_per_sec(chunk_seconds) -> Optional[float]:
    """Epoch rate over every chunk after the first (which pays the one-time
    kernel build and warm-up); None with fewer than two chunks."""
    if not chunk_seconds or len(chunk_seconds) < 2:
        return None
    sec = sum(s for _, s in chunk_seconds[1:])
    return sum(e for e, _ in chunk_seconds[1:]) / sec if sec > 0 else None


class QuantumKSDVariationalInference:
    """Quantum-Born-machine KSD engine. Constructor keywords mirror the JAX
    engine's ``qbm_*`` names; ``device`` defaults to the card. For
    ``qbm_ansatz_type="bn_structured"``, ``qbm_edges`` defaults to the
    network's latent edges (``sim.structured.latent_edges``)."""

    def __init__(self, bayesian_network: BayesianNetwork, latent_vars_names: Sequence[str],
                 observed_vars_names: Sequence[str], qbm_num_latent_vars: int,
                 qbm_ansatz_layers: int = 1, qbm_ansatz_type: str = "hardware_efficient",
                 qbm_init_method: str = "small_random", base_kernel_length_scale=1.0,
                 dtype=torch.float32, seed: int = 0, qbm_backend: str = "auto",
                 device="cuda", qbm_edges=None):
        if qbm_ansatz_type == "bn_structured" and qbm_edges is None:
            qbm_edges = latent_edges(bayesian_network, latent_vars_names)
        self.bn = bayesian_network
        self.latent_vars_names = list(latent_vars_names)
        self.observed_vars_names = list(observed_vars_names)
        self.num_latent_vars = qbm_num_latent_vars
        self.num_observed_vars = len(observed_vars_names)
        self.base_kernel_length_scale = resolve_length_scale(
            base_kernel_length_scale, self.num_latent_vars)
        self.dtype = dtype
        self.seed = seed
        self.device = torch.device(device)
        self.born_machine = QuantumBornMachine(
            qbm_num_latent_vars, ansatz_layers=qbm_ansatz_layers, ansatz_type=qbm_ansatz_type,
            init_method=qbm_init_method, backend=qbm_backend, dtype=dtype, device=device,
            edges=qbm_edges)
        self.params = self.born_machine.init(torch.Generator().manual_seed(seed))
        self.history_: Optional[dict] = None

    def build_operator(self, x_observation_dict) -> SteinOperator:
        t = self.bn.conditional_joint_table(self.latent_vars_names, x_observation_dict)
        return SteinOperator(score_table(t), self.num_latent_vars,
                             self.base_kernel_length_scale, dtype=self.dtype,
                             device=self.device)

    def train(self, x_observation_dict: Dict[str, int], num_epochs: int,
              lr_born_machine: float, verbose: bool = True, true_posterior_for_tvd=None,
              use_lr_scheduler: bool = True, gradient_clip_norm: float = 10.0,
              optimizer_type: str = "adam", adam_betas=(0.9, 0.999),
              chunk_epochs: Optional[int] = None) -> dict:
        if self.num_observed_vars > 0 and set(x_observation_dict) != set(self.observed_vars_names):
            raise ValueError("Keys in x_observation_dict must match self.observed_vars_names.")
        op = self.build_operator(x_observation_dict)
        posterior_vec = _posterior_vec_from(true_posterior_for_tvd, self.num_latent_vars,
                                            self.dtype, self.device)
        optimizer = make_optimizer(optimizer_type, lr_born_machine, num_epochs,
                                   use_lr_scheduler, adam_betas, gradient_clip_norm)
        t0 = time.perf_counter()
        out = run_ksd_scan(probs_fn=self.born_machine.probs, params0=self.params, op=op,
                           num_epochs=num_epochs, optimizer=optimizer,
                           posterior_vec=posterior_vec, chunk_epochs=chunk_epochs)
        elapsed = time.perf_counter() - t0

        self.params = out["params"]
        self.best_params_ = out["best_params"]
        self.best_tvd_ = out["best_tvd"]
        self.best_epoch_ = out["best_epoch"]
        history = {k: out[k].tolist() for k in ("loss_ksd", "tvd", "grad_norm")}
        history["epochs_per_sec"] = num_epochs / elapsed if elapsed > 0 else float("inf")
        history["train_seconds"] = elapsed
        history["num_skipped_updates"] = int(out["skipped"].sum())
        steady = steady_epochs_per_sec(out["chunk_seconds"])
        if steady is not None:
            history["epochs_per_sec_steady"] = steady
        self.history_ = history

        if posterior_vec is not None and np.isfinite(self.best_tvd_):
            if verbose:
                print(f"Restoring best parameters (TVD: {self.best_tvd_:.6f})")
            self.params = self.best_params_
        if verbose:
            print(f"Quantum KSD training: {num_epochs} epochs in {elapsed:.3f}s "
                  f"({history['epochs_per_sec']:.1f} epochs/s)")
        return history

    def get_prob_dict(self) -> dict:
        return self.born_machine.get_prob_dict(self.params)
