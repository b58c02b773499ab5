"""Distributed quantum-KSD engine: the full training loop with every 2^n
buffer sharded over a mesh of ranks.

Counterpart of ``tensornetworks_tpu/engines/distributed.py``. The engine
runs the shared ``run_ksd_scan`` loop (reference loss ``ksd_vi.py:133-134``,
per-epoch TVD, best restore, chunking, durable resume) on every rank, with
the circuit and the Stein quadratic form sharded over the mesh's ``state``
axis (``parallel.distributed_ansatz``, ``parallel.distributed_train``):
the statevector, the probabilities, the score table, the matvec columns and
the posterior are 2^n/D per rank. The loop's ``reducer`` sums each rank's
share of the gradient and of the TVD, so every rank takes the same step and
keeps the same best; rank 0 alone writes the resume snapshot, which holds
only replicated state.

Every rank constructs the engine and calls ``train`` (one process per rank:
``parallel.launch.spawn`` or ``torchrun``). All three reference ansätze and
``bn_structured`` (with optional angle-embedding conditioning) run.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core.bayes_net import BayesianNetwork
from ..core.bits import generate_all_binary_outcomes
from ..models.born_quantum import init_circuit_params
from ..ops.hamming import resolve_length_scale
from ..ops.stein import score_table
from ..parallel.comm import MeshReducer
from ..parallel.distributed_ansatz import make_distributed_ansatz_probs
from ..parallel.distributed_train import make_distributed_stein_quadform, place_stein_tables
from ..parallel.launch import local_device
from ..parallel.mesh import STATE_AXIS, axis_size, gather_full, make_mesh, replicate, state_shard
from ..sim.ansatz import num_ansatz_params
from ..sim.structured import latent_edges
from .common import highest_matmul_precision, make_optimizer
from .ksd import _posterior_vec_from, run_ksd_scan, steady_epochs_per_sec


class DistributedSteinOperator:
    """The Stein operator's quadratic form on the state shards
    (``make_distributed_stein_quadform``), duck-typed for ``run_ksd_scan``;
    ``S`` is this rank's rows of the score table."""

    def __init__(self, mesh: DeviceMesh, score: np.ndarray, num_vars: int,
                 length_scale: float = 1.0, dtype=torch.float32, group: int = 7, device="cuda"):
        self.mesh = mesh
        self.num_vars = num_vars
        self.length_scale = length_scale
        self.quadform = make_distributed_stein_quadform(mesh, num_vars, length_scale, group)
        (self.S,) = place_stein_tables(mesh, score, num_vars, dtype, device)

    def args(self):
        return (self.S,)

    def ksd_loss_from(self, q, S, eps: float = 1e-12):
        return torch.sqrt(torch.clamp(self.quadform(q, S), min=eps))

    def ksd_loss(self, q, eps: float = 1e-12):
        return self.ksd_loss_from(q, self.S, eps=eps)


class DistributedQuantumKSDVariationalInference:
    """Mesh-sharded counterpart of ``QuantumKSDVariationalInference``: the
    same ``train`` and history keys, every 2^n buffer distributed. ``mesh``
    defaults to ``make_mesh(num_devices)`` over the initialised world;
    ``device`` to this rank's card. θ0 is the quantum engine's draw from
    ``seed``, broadcast from rank 0."""

    def __init__(self, bayesian_network: BayesianNetwork, latent_vars_names: Sequence[str],
                 observed_vars_names: Sequence[str], qbm_num_latent_vars: int,
                 qbm_ansatz_layers: int = 1, qbm_conditioning_dim: int = 0,
                 qbm_ansatz_type: str = "hardware_efficient",
                 qbm_init_method: str = "small_random", base_kernel_length_scale=1.0,
                 dtype=torch.float32, seed: int = 0, qbm_edges=None,
                 mesh: Optional[DeviceMesh] = None, num_devices: Optional[int] = None,
                 state_dtype=torch.complex64, device="cuda"):
        if mesh is None:
            mesh = make_mesh(num_devices)
        if qbm_ansatz_type == "bn_structured" and qbm_edges is None:
            qbm_edges = latent_edges(bayesian_network, latent_vars_names)
        self.mesh = mesh
        self.device = local_device(device)
        self.bn = bayesian_network
        self.latent_vars_names = list(latent_vars_names)
        self.observed_vars_names = list(observed_vars_names)
        self.num_latent_vars = qbm_num_latent_vars
        self.base_kernel_length_scale = resolve_length_scale(base_kernel_length_scale,
                                                             qbm_num_latent_vars)
        self.dtype = dtype
        self.seed = seed
        self.ansatz_type = qbm_ansatz_type
        self.ansatz_layers = qbm_ansatz_layers
        self.conditioning_dim = qbm_conditioning_dim
        self.edges = list(qbm_edges) if qbm_edges is not None else None
        self._probs = make_distributed_ansatz_probs(
            mesh, qbm_num_latent_vars, qbm_ansatz_layers, qbm_ansatz_type, dtype=state_dtype,
            edges=self.edges, conditioning=qbm_conditioning_dim > 0)
        self.num_params = num_ansatz_params(qbm_num_latent_vars, qbm_ansatz_layers,
                                            qbm_ansatz_type)
        self.init_method = qbm_init_method
        theta = init_circuit_params(self.num_params, qbm_init_method,
                                    torch.Generator().manual_seed(seed))
        self.params = replicate(theta.to(device=self.device, dtype=dtype), mesh)
        self.history_: Optional[dict] = None

    def _embed_angles(self, x_observation_dict) -> torch.Tensor:
        n = self.num_latent_vars
        x = np.asarray([x_observation_dict[k] for k in self.observed_vars_names],
                       dtype=np.float64)
        reps = -(-n // x.shape[0])
        return torch.as_tensor(np.pi * np.tile(x, reps)[:n], dtype=self.dtype,
                               device=self.device)

    def build_operator(self, x_observation_dict) -> DistributedSteinOperator:
        t = self.bn.conditional_joint_table(self.latent_vars_names, x_observation_dict)
        return DistributedSteinOperator(self.mesh, score_table(t), self.num_latent_vars,
                                        self.base_kernel_length_scale, dtype=self.dtype,
                                        device=self.device)

    @highest_matmul_precision()
    def train(self, x_observation_dict: Dict[str, int], num_epochs: int,
              lr_born_machine: float, verbose: bool = True, true_posterior_for_tvd=None,
              use_lr_scheduler: bool = True, gradient_clip_norm: float = 10.0,
              optimizer_type: str = "adam", adam_betas=(0.9, 0.999),
              seed: Optional[int] = None, chunk_epochs: Optional[int] = None,
              resume_state_path: Optional[str] = None,
              keep_resume_state: bool = False) -> dict:
        """``run_ksd_scan`` on this rank's shards; the history (``loss_ksd``,
        ``tvd``, ``grad_norm``, the rates, ``num_skipped_updates``) is the
        same on every rank. ``resume_state_path`` (needs ``chunk_epochs``):
        durable per-chunk resume, written by rank 0; ``keep_resume_state``
        leaves the snapshot in place at the end (the runner's phases).
        ``seed`` is the JAX engine's argument; the forward draws nothing, so
        it changes nothing."""
        del seed
        if resume_state_path and not chunk_epochs:
            raise ValueError("resume_state_path requires chunk_epochs")
        op = self.build_operator(x_observation_dict)
        posterior_vec = _posterior_vec_from(true_posterior_for_tvd, self.num_latent_vars,
                                            self.dtype, "cpu")
        if posterior_vec is not None:
            posterior_vec = state_shard(posterior_vec, self.mesh).to(self.device)
        optimizer = make_optimizer(optimizer_type, lr_born_machine, num_epochs,
                                   use_lr_scheduler, adam_betas, gradient_clip_norm)
        if self.conditioning_dim > 0:
            embed = self._embed_angles(x_observation_dict)

            def probs_fn(p):
                return self._probs(p, embed).to(self.dtype)
        else:
            def probs_fn(p):
                return self._probs(p).to(self.dtype)

        t0 = time.perf_counter()
        out = run_ksd_scan(probs_fn=probs_fn, params0=self.params, op=op,
                           num_epochs=num_epochs, optimizer=optimizer,
                           posterior_vec=posterior_vec, chunk_epochs=chunk_epochs,
                           resume_state_path=resume_state_path,
                           keep_resume_state=keep_resume_state,
                           reducer=MeshReducer(self.mesh))
        elapsed = time.perf_counter() - t0

        self.params = out["params"]
        self.best_params_ = out["best_params"]
        self.best_probs_ = out["best_probs"]  # this rank's (2^n/D,) shard
        self.best_tvd_ = out["best_tvd"]
        self.best_epoch_ = out["best_epoch"]
        history = {k: out[k].tolist() for k in ("loss_ksd", "tvd", "grad_norm")}
        history["epochs_per_sec"] = (out["epochs_dispatched"] / elapsed if elapsed > 0
                                     else float("inf"))
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
            print(f"Distributed quantum KSD ({self.mesh.mesh.numel()} ranks, "
                  f"{axis_size(self.mesh, STATE_AXIS)} state shards): "
                  f"{out['epochs_dispatched']} epochs in {elapsed:.3f}s "
                  f"({history['epochs_per_sec']:.1f} epochs/s)")
        return history

    def get_prob_dict(self, x_condition=None) -> dict:
        """The learned distribution, gathered on every rank (small n only)."""
        with torch.no_grad():
            if self.conditioning_dim > 0:
                angles = torch.as_tensor(x_condition, dtype=self.dtype, device=self.device)
                q = self._probs(self.params, angles)
            else:
                q = self._probs(self.params)
            p = gather_full(q, self.mesh).cpu().numpy()
        outcomes = generate_all_binary_outcomes(self.num_latent_vars)
        return {t: float(p[i]) for i, t in enumerate(outcomes)}
