"""Sampled-KSD variational inference: U-statistic KSD with REINFORCE
gradients, the path past exact Stein enumeration.

Counterpart of ``tensornetworks_tpu/engines/sampled.py``. The exact engines
evaluate ``qᵀ K_p q`` over all 2^n outcomes; this engine builds no 2^n Stein
structure. Per epoch it

1. samples M outcomes from the Born machine: the inverse CDF of the flat
   distribution (``sampling="flat"``), or two-stage on its (R, C) view
   (``"two_stage"``, auto from 20 qubits: row marginals, then the M
   gathered rows; no 2^n-long CDF), with ``log q`` at the shots from the
   same row gather;
2. scores the shots from the network's CPT factors (``core/factors.py``);
3. builds the (M, M) Stein Gram on the sample rows and its U-statistic;
4. takes the gradient of the REINFORCE surrogate (the loo, mean or no
   baseline, or the linear control variate ``"cv"``) while the value reads
   as the U-statistic: ``(est − surrogate).detach() + surrogate``.

The Born machine's forward is still the exact |ψ|²: the circuit kernels up
to 24 qubits, and on to 30 for an FP32 machine under the kernel precision
``highest`` (the grid kernels' gate path, whose backward is an adjoint
that saves only the final state); past them the blocked executor, with the
adjoint backward from 26 for the reference ansätze. q is cast to float32,
as in the JAX engine.

As in the port's other engines the epochs are an eager loop whose state
(parameters, Adam moments, best snapshot, history) stays on the device; the
host waits for it only at chunk ends; under a profiler the epochs carry
``run_ksd_scan``'s spans, with ``sampled.shots``, ``sampled.scores`` and
``sampled.gram`` inside the loss. Shots come from ``sampler(P,
num_samples, generator)``: ``sim.sampling.inverse_cdf_sampler`` by default,
with one generator per run seeded by ``seed``, M uniforms per epoch (flat)
or M for the rows and then M for the columns (two-stage).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..core.bayes_net import BayesianNetwork
from ..core.bits import all_bitstrings, torch_index_to_bits
from ..core.factors import make_latent_log_joint_fn
from ..models.born_quantum import QuantumBornMachine, auto_backend
from ..ops.hamming import resolve_length_scale
from ..ops.stein_sampled import (ksd_ustat, reinforce_surrogate, reinforce_surrogate_cv,
                                 score_at_samples, stein_gram_samples)
from ..sim.sampling import gather_2d, inverse_cdf_sampler
from ..sim.structured import latent_edges
from ..train import profile_trace, span
from .common import global_norm, guarded_update, highest_matmul_precision, make_optimizer
from .ksd import _posterior_vec_from, steady_epochs_per_sec

# From this many qubits ``qbm_grad_method="auto"`` takes the adjoint
# backward where the machine's backend is ``blocked`` (the JAX engine's
# switch: past it the checkpointed autodiff backward ran out of one chip's
# memory).
ADJOINT_MIN_QUBITS = 26
TWO_STAGE_MIN_QUBITS = 20


class SampledKSDVariationalInference:
    """Quantum (or classical) Born-machine VI with sampled KSD.

    The quantum engine's training surface plus ``num_samples`` (shots per
    epoch), ``sampling`` (``flat``, ``two_stage`` or ``auto``) and
    ``grad_baseline`` (``loo``, ``mean``, ``none`` or ``cv``).
    ``born_machine`` may be any model with ``init(generator)`` and
    ``probs(params)``; by default a ``QuantumBornMachine`` from the
    ``qbm_*`` keywords (``qbm_edges`` defaults to the network's latent
    edges for ``bn_structured``). ``qbm_grad_method="auto"`` takes the
    adjoint from 26 qubits where the machine's backend, named or the one
    ``auto`` picks (``born_quantum.auto_backend``), is ``blocked``;
    ``qbm_remat_layers=None`` checkpoints the blocked executor's layers
    from 26 qubits when its backward is autograd. ``device`` defaults to
    the card."""

    def __init__(self, bn: BayesianNetwork, latent_vars_names: Sequence[str],
                 observed_vars_names: Sequence[str], *, qbm_ansatz_layers: int = 4,
                 qbm_ansatz_type: str = "hardware_efficient",
                 qbm_init_method: str = "small_random", qbm_backend: str = "auto",
                 qbm_edges=None, born_machine=None, base_kernel_length_scale=1.0,
                 num_samples: int = 512, seed: int = 0,
                 qbm_remat_layers: Optional[bool] = None, sampling: str = "auto",
                 qbm_grad_method: str = "auto", grad_baseline: str = "loo",
                 dtype=torch.float32, device="cuda"):
        self.bn = bn
        self.latent_vars_names = list(latent_vars_names)
        self.observed_vars_names = list(observed_vars_names)
        self.num_latent_vars = n = len(self.latent_vars_names)
        self.length_scale = resolve_length_scale(base_kernel_length_scale, n)
        self.num_samples = int(num_samples)
        self.seed = seed
        self.device = torch.device(device)
        if qbm_ansatz_type == "bn_structured" and qbm_edges is None:
            qbm_edges = latent_edges(bn, self.latent_vars_names)
        blocked = (auto_backend(n, qbm_ansatz_type, dtype) if qbm_backend == "auto"
                   else qbm_backend) == "blocked"
        use_adjoint = qbm_grad_method == "adjoint" or (
            qbm_grad_method == "auto" and n >= ADJOINT_MIN_QUBITS and blocked)
        if qbm_remat_layers is None:
            qbm_remat_layers = n >= ADJOINT_MIN_QUBITS and blocked and not use_adjoint
        if born_machine is None:
            born_machine = QuantumBornMachine(
                n, ansatz_layers=qbm_ansatz_layers, ansatz_type=qbm_ansatz_type,
                init_method=qbm_init_method,
                backend="blocked" if use_adjoint and qbm_backend == "auto" else qbm_backend,
                dtype=dtype, device=device, edges=qbm_edges, remat_layers=qbm_remat_layers,
                grad_method="adjoint" if use_adjoint else "autodiff")
        self.born_machine = born_machine
        self.params = born_machine.init(torch.Generator().manual_seed(seed))
        if sampling == "auto":
            sampling = "two_stage" if n >= TWO_STAGE_MIN_QUBITS else "flat"
        if sampling not in ("flat", "two_stage"):
            raise ValueError(f"sampling must be flat|two_stage|auto, got {sampling!r}")
        self.sampling = sampling
        if grad_baseline not in ("loo", "mean", "none", "cv"):
            raise ValueError(f"grad_baseline must be loo|mean|none|cv, got {grad_baseline!r}")
        self.grad_baseline = grad_baseline
        self.history_: Optional[dict] = None

    @highest_matmul_precision()
    def train(self, x_observation_dict: Dict[str, int], num_epochs: int,
              lr_born_machine: float, verbose: bool = True, true_posterior_for_tvd=None,
              use_lr_scheduler: bool = True, gradient_clip_norm: float = 10.0,
              optimizer_type: str = "adam", adam_betas=(0.9, 0.999),
              seed: Optional[int] = None, chunk_epochs: Optional[int] = None,
              reuse_loss_forward_for_eval: bool = False,
              sampler: Callable = inverse_cdf_sampler,
              profile_dir: Optional[str] = None) -> dict:
        """Train for ``num_epochs``; returns the history (``loss_ksd`` is
        the per-epoch U-statistic, ``tvd``, ``grad_norm``, the rates and
        ``num_skipped_updates``).

        ``reuse_loss_forward_for_eval``: epoch t's loss forward is epoch
        t−1's post-update distribution, so the TVD is read from it and the
        separate evaluation forward goes; the final parameters are evaluated
        once after the loop, and ``tvd[t]`` is then epoch t−1's.
        ``chunk_epochs``: a host sync per chunk and ``epochs_per_sec_steady``;
        the results are the same. ``seed`` overrides the engine's seed for
        the shot generator. ``sampler(P, num_samples, generator)`` returns
        the shots' flat indices for a (2^n,) ``P``, or ``(flat_idx, r, c)``
        for its (R, C) view. ``profile_dir``: a ``torch.profiler`` trace
        of the epochs (``train.profile_trace``)."""
        n, M = self.num_latent_vars, self.num_samples
        dev = self.device
        log_joint_z = make_latent_log_joint_fn(self.bn, self.latent_vars_names,
                                               x_observation_dict, device=dev)
        posterior_vec = _posterior_vec_from(true_posterior_for_tvd, n, torch.float32, dev)
        track = posterior_vec is not None
        reuse_eval = reuse_loss_forward_for_eval and track
        optimizer = make_optimizer(optimizer_type, lr_born_machine, num_epochs,
                                   use_lr_scheduler, adam_betas, gradient_clip_norm)
        bm = self.born_machine
        two_stage = self.sampling == "two_stage"
        rb = (n + 1) // 2
        R, C = 1 << rb, 1 << (n - rb)
        use_cv = self.grad_baseline == "cv"
        if use_cv:
            # (2^⌈n/2⌉, ⌈n/2⌉) bit matrices: the exact differentiable bit
            # marginals E_qθ[z] from two axis reductions of the (R, C) view.
            Br = torch.as_tensor(all_bitstrings(rb, np.float32), device=dev)
            Bc = torch.as_tensor(all_bitstrings(n - rb, np.float32), device=dev)
        gen = torch.Generator(device=dev).manual_seed(self.seed if seed is None else seed)

        def epoch_loss(p):
            q = bm.probs(p).to(torch.float32)
            P2 = q.reshape(R, C)
            with span("sampled.shots"):
                if two_stage:
                    idx, r, c = sampler(P2.detach(), M, gen)
                    q_at = gather_2d(P2, r, c)
                else:
                    idx = sampler(q.detach(), M, gen)
                    q_at = q[idx]
            log_q = torch.log(q_at.clamp(min=1e-12))
            with span("sampled.scores"):
                Z = torch_index_to_bits(idx, n, dtype=torch.float32)
                S_x = score_at_samples(log_joint_z, Z)
            with span("sampled.gram"):
                gram = stein_gram_samples(S_x.to(torch.float32), Z, n, self.length_scale)
                est = ksd_ustat(gram)
                if use_cv:
                    marg = torch.cat([P2.sum(dim=1) @ Br, P2.sum(dim=0) @ Bc])
                    surrogate = reinforce_surrogate_cv(gram, log_q, Z, marg)
                else:
                    surrogate = reinforce_surrogate(gram, log_q, self.grad_baseline)
            return (est - surrogate).detach() + surrogate, q.detach()

        def tvd_of(q):
            return 0.5 * (q - posterior_vec).abs().sum()

        params = self.params.detach().clone()
        opt_state = optimizer.init(params)
        hist = torch.full((4, num_epochs), float("nan"), dtype=torch.float32, device=dev)
        best_tvd = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
        best_epoch = torch.zeros((), dtype=torch.int64, device=dev)
        best_params = params.clone()

        def take_best(tvd, epoch, candidate):
            nonlocal best_tvd, best_epoch, best_params
            improved = tvd < best_tvd
            best_tvd = torch.where(improved, tvd, best_tvd)
            best_epoch = torch.where(improved, torch.full_like(best_epoch, epoch), best_epoch)
            best_params = torch.where(improved, candidate, best_params)

        chunk = chunk_epochs if chunk_epochs and chunk_epochs < num_epochs else num_epochs
        chunk_seconds = []
        t0 = time.perf_counter()
        with profile_trace(profile_dir):
            for start in range(0, num_epochs, chunk):
                t_chunk = time.perf_counter()
                for epoch in range(start, min(start + chunk, num_epochs)):
                    with span("engine.epoch"):
                        p = params.detach().requires_grad_(True)
                        with span("engine.loss"):
                            loss, q = epoch_loss(p)
                        with span("engine.backward"):
                            (grads,) = torch.autograd.grad(loss, p)
                        ok = torch.isfinite(loss)
                        tvd = torch.full_like(loss, float("nan"))
                        if reuse_eval:
                            # q is the previous epoch's post-update distribution;
                            # epoch 0's is the init, not a candidate.
                            with span("engine.eval"):
                                tvd = tvd_of(q)
                                if epoch > 0:
                                    take_best(tvd, epoch - 1, params)
                        params, opt_state = guarded_update(optimizer, grads, opt_state, params, ok)
                        if track and not reuse_eval:
                            with span("engine.eval"):
                                with torch.no_grad():
                                    tvd = tvd_of(bm.probs(params).to(torch.float32))
                                take_best(tvd, epoch, params)
                        hist[:, epoch] = torch.stack([loss.detach().float(), tvd.float(),
                                                      global_norm([grads]).float(), (~ok).float()])
                with span("engine.sync"):
                    best_tvd.item()  # host sync closes the chunk
                chunk_seconds.append((min(chunk, num_epochs - start),
                                      time.perf_counter() - t_chunk))
                if verbose and chunk < num_epochs and len(chunk_seconds) % 10 == 0:
                    done = sum(e for e, _ in chunk_seconds)
                    # The JAX engine prints best_tvd=inf when the TVD is not
                    # tracked (ADVICE.md); the suffix is guarded as in
                    # run_ksd_scan's progress line.
                    bt = float(best_tvd)
                    suffix = f" best_tvd={bt:.4f}" if np.isfinite(bt) else ""
                    print(f"  [chunk] {done}/{num_epochs} epochs "
                          f"{time.perf_counter() - t0:.0f}s{suffix}", flush=True)
            if reuse_eval:
                # The loop's TVDs lag one epoch: evaluate the final parameters
                # once (the only extra forward of the run).
                with span("engine.eval"), torch.no_grad():
                    take_best(tvd_of(bm.probs(params).to(torch.float32)), num_epochs - 1,
                              params)
        history_dev = hist.cpu().numpy()
        elapsed = time.perf_counter() - t0

        self.params = params
        self.best_tvd_ = float(best_tvd)
        self.best_epoch_ = int(best_epoch)
        self.best_params_ = best_params
        if track and np.isfinite(self.best_tvd_):
            if verbose:
                print(f"Restoring best parameters (TVD: {self.best_tvd_:.6f})")
            self.params = best_params
        history = {"loss_ksd": history_dev[0].tolist(), "tvd": history_dev[1].tolist(),
                   "grad_norm": history_dev[2].tolist()}
        history["epochs_per_sec"] = num_epochs / elapsed if elapsed > 0 else float("inf")
        if chunk < num_epochs:
            steady = steady_epochs_per_sec(chunk_seconds)
            if steady is not None:
                history["epochs_per_sec_steady"] = steady
        history["train_seconds"] = elapsed
        history["num_skipped_updates"] = int(history_dev[3].sum())
        self.history_ = history
        if verbose:
            print(f"Sampled KSD ({M} shots/epoch): {num_epochs} epochs in {elapsed:.3f}s "
                  f"({history['epochs_per_sec']:.1f} epochs/s)")
        return history

    def get_prob_dict(self) -> dict:
        return self.born_machine.get_prob_dict(self.params)
