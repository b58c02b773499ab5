"""Distributed sampled-KSD engine: sampled KSD with every 2^n buffer sharded
over a mesh of ranks.

Counterpart of ``tensornetworks_tpu/engines/distributed_sampled.py``. The
exact distributed engine's (2^n/D, n) score shards and n+1 Kronecker
columns grow with 2^n; this engine composes the pieces that do not:

1. the lean distributed adjoint executor (the state 2^n/D per rank, its
   backward un-computing it: ``parallel.distributed_ansatz``),
2. distributed two-stage sampling (the shots of ``sample_indices_2d`` on the
   gathered matrix, bit for bit; ``parallel.distributed_sampled``),
3. the sampled U-statistic estimator (CPT-factored scores, the (M, M) sample
   Gram, the REINFORCE surrogate with the loo, mean, none or cv baseline;
   ``ops.stein_sampled``), replicated on every rank, its gradient flowing
   back through the summed rows into the owning shard and the sharded
   circuit.

Every rank draws the same uniforms from a generator seeded alike (M for the
rows, then M for the columns each epoch, as the single-device engine's
default sampler draws them), so a run is shot for shot the port's
``SampledKSDVariationalInference`` with two-stage sampling given the same
seed. The epoch loop is that engine's: eager, its state on the device, a
host sync per chunk, and its spans (``engine.epoch`` ⊃ ``.loss``,
``.backward``, ``.update``, ``.eval``; ``sampled.shots``, ``.scores``,
``.gram``). The history adds ``exchange_bytes_per_epoch``: the bytes this
rank sent in the window's exchanges (``comm.BYTES``) over its epochs.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core.bayes_net import BayesianNetwork
from ..core.bits import all_bitstrings, torch_index_to_bits
from ..core.factors import make_latent_log_joint_fn
from ..models.born_quantum import init_circuit_params
from ..ops.hamming import resolve_length_scale
from ..ops.stein_sampled import (ksd_ustat, reinforce_surrogate, reinforce_surrogate_cv,
                                 score_at_samples, stein_gram_samples)
from ..parallel.comm import BYTES, MeshReducer, psum_replicated
from ..parallel.distributed_ansatz import make_distributed_ansatz_probs
from ..parallel.distributed_sampled import make_distributed_two_stage_sampler
from ..parallel.launch import local_device
from ..parallel.mesh import STATE_AXIS, axis_size, make_mesh, replicate, state_shard
from ..sim.ansatz import num_ansatz_params
from ..sim.sampling import draw_uniforms
from ..sim.structured import latent_edges
from ..train import span
from .common import global_norm, guarded_update, highest_matmul_precision, make_optimizer
from .ksd import _posterior_vec_from, steady_epochs_per_sec


class DistributedSampledKSDVariationalInference:
    """Mesh-sharded counterpart of ``SampledKSDVariationalInference``: the
    same estimator and training surface, every 2^n buffer distributed.
    ``mesh`` defaults to ``make_mesh(num_devices)``; ``device`` to this
    rank's card; θ0 is the single-device engine's draw from ``seed`` in
    ``dtype``, broadcast from rank 0. q is cast to float32 for the shots
    and the estimator, as in the single-device engine."""

    def __init__(self, bayesian_network: BayesianNetwork, latent_vars_names: Sequence[str],
                 observed_vars_names: Sequence[str], *, qbm_ansatz_layers: int = 4,
                 qbm_ansatz_type: str = "hardware_efficient",
                 qbm_init_method: str = "small_random", qbm_edges=None,
                 base_kernel_length_scale=1.0, num_samples: int = 512, seed: int = 0,
                 grad_baseline: str = "loo", mesh: Optional[DeviceMesh] = None,
                 num_devices: Optional[int] = None, state_dtype=torch.complex64,
                 dtype=torch.float32, device="cuda"):
        if mesh is None:
            mesh = make_mesh(num_devices)
        if qbm_ansatz_type == "bn_structured" and qbm_edges is None:
            qbm_edges = latent_edges(bayesian_network, latent_vars_names)
        self.mesh = mesh
        self.device = local_device(device)
        self.bn = bayesian_network
        self.latent_vars_names = list(latent_vars_names)
        self.observed_vars_names = list(observed_vars_names)
        self.num_latent_vars = n = len(self.latent_vars_names)
        self.length_scale = resolve_length_scale(base_kernel_length_scale, n)
        self.num_samples = int(num_samples)
        self.seed = seed
        if grad_baseline not in ("loo", "mean", "none", "cv"):
            raise ValueError(f"grad_baseline must be loo|mean|none|cv, got {grad_baseline!r}")
        self.grad_baseline = grad_baseline
        self.ansatz_type = qbm_ansatz_type
        self.ansatz_layers = qbm_ansatz_layers
        self.edges = list(qbm_edges) if qbm_edges is not None else None
        self._probs = make_distributed_ansatz_probs(mesh, n, qbm_ansatz_layers, qbm_ansatz_type,
                                                    dtype=state_dtype, edges=self.edges)
        self.num_params = num_ansatz_params(n, qbm_ansatz_layers, qbm_ansatz_type)
        theta = init_circuit_params(self.num_params, qbm_init_method,
                                    torch.Generator().manual_seed(seed))
        self.params = replicate(theta.to(device=self.device, dtype=dtype), mesh)
        self.history_: Optional[dict] = None

    @highest_matmul_precision()
    def train(self, x_observation_dict: Dict[str, int], num_epochs: int,
              lr_born_machine: float, verbose: bool = True, true_posterior_for_tvd=None,
              use_lr_scheduler: bool = True, gradient_clip_norm: float = 10.0,
              optimizer_type: str = "adam", adam_betas=(0.9, 0.999),
              seed: Optional[int] = None, chunk_epochs: Optional[int] = None,
              reuse_loss_forward_for_eval: bool = False) -> dict:
        """The single-device engine's ``train`` on this rank's shards (shot
        for shot its two-stage run given the same seed); the history is the
        same on every rank. ``seed`` overrides the engine's seed for the
        shot generator."""
        n, M = self.num_latent_vars, self.num_samples
        dev = self.device
        mesh = self.mesh
        reducer = MeshReducer(mesh)
        log_joint_z = make_latent_log_joint_fn(self.bn, self.latent_vars_names,
                                               x_observation_dict, device=dev)
        posterior_vec = _posterior_vec_from(true_posterior_for_tvd, n, torch.float32, "cpu")
        track = posterior_vec is not None
        if track:
            posterior_vec = state_shard(posterior_vec, mesh).to(dev)
        reuse_eval = reuse_loss_forward_for_eval and track
        optimizer = make_optimizer(optimizer_type, lr_born_machine, num_epochs,
                                   use_lr_scheduler, adam_betas, gradient_clip_norm)
        rb = (n + 1) // 2
        R, C = 1 << rb, 1 << (n - rb)
        Rl = R // axis_size(mesh, STATE_AXIS)
        sampler = make_distributed_two_stage_sampler(mesh, n, M)
        use_cv = self.grad_baseline == "cv"
        if use_cv:
            # This rank's rows of the row-bit matrix: the bit marginals are
            # partial sums over the shards, summed by psum_replicated.
            Br = state_shard(torch.as_tensor(all_bitstrings(rb, np.float32)), mesh).to(dev)
            Bc = torch.as_tensor(all_bitstrings(n - rb, np.float32), device=dev)
        gen = torch.Generator(device=dev).manual_seed(self.seed if seed is None else seed)
        probs = self._probs

        def epoch_loss(p):
            q = probs(p).to(torch.float32)
            P2l = q.reshape(Rl, C)
            with span("sampled.shots"):
                u_r = draw_uniforms(gen, M, torch.float32, dev)
                u_c = draw_uniforms(gen, M, torch.float32, dev)
                idx, q_at = sampler(P2l, u_r, u_c)
            log_q = torch.log(q_at.clamp(min=1e-12))
            with span("sampled.scores"):
                Z = torch_index_to_bits(idx, n, dtype=torch.float32)
                S_x = score_at_samples(log_joint_z, Z)
            with span("sampled.gram"):
                gram = stein_gram_samples(S_x.to(torch.float32), Z, n, self.length_scale)
                est = ksd_ustat(gram)
                if use_cv:
                    marg = psum_replicated(torch.cat([P2l.sum(dim=1) @ Br,
                                                      P2l.sum(dim=0) @ Bc]), mesh)
                    surrogate = reinforce_surrogate_cv(gram, log_q, Z, marg)
                else:
                    surrogate = reinforce_surrogate(gram, log_q, self.grad_baseline)
            return (est - surrogate).detach() + surrogate, q.detach()

        def tvd_of(q):
            return reducer.state_sum(0.5 * (q - posterior_vec).abs().sum())

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
        sent = BYTES["exchange"]
        t0 = time.perf_counter()
        for start in range(0, num_epochs, chunk):
            t_chunk = time.perf_counter()
            for epoch in range(start, min(start + chunk, num_epochs)):
                with span("engine.epoch"):
                    p = params.detach().requires_grad_(True)
                    with span("engine.loss"):
                        loss, q = epoch_loss(p)
                    with span("engine.backward"):
                        (grads,) = torch.autograd.grad(loss, p)
                        grads = reducer.grads(grads)
                    ok = torch.isfinite(loss)
                    tvd = torch.full_like(loss, float("nan"))
                    if reuse_eval:
                        with span("engine.eval"):
                            tvd = tvd_of(q)
                            if epoch > 0:
                                take_best(tvd, epoch - 1, params)
                    params, opt_state = guarded_update(optimizer, grads, opt_state, params, ok)
                    if track and not reuse_eval:
                        with span("engine.eval"):
                            with torch.no_grad():
                                tvd = tvd_of(probs(params).to(torch.float32))
                            take_best(tvd, epoch, params)
                    hist[:, epoch] = torch.stack([loss.detach().float(), tvd.float(),
                                                  global_norm([grads]).float(), (~ok).float()])
            with span("engine.sync"):
                best_tvd.item()  # host sync closes the chunk
            chunk_seconds.append((min(chunk, num_epochs - start), time.perf_counter() - t_chunk))
        if reuse_eval:
            with span("engine.eval"), torch.no_grad():
                take_best(tvd_of(probs(params).to(torch.float32)), num_epochs - 1, params)
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
        history["exchange_bytes_per_epoch"] = (BYTES["exchange"] - sent) / num_epochs
        self.history_ = history
        if verbose:
            print(f"Distributed sampled KSD ({mesh.mesh.numel()} ranks, {M} shots/epoch): "
                  f"{num_epochs} epochs in {elapsed:.3f}s "
                  f"({history['epochs_per_sec']:.1f} epochs/s)")
        return history
