"""Distributed scale runner: the exact KSD engine with the 2^n state sharded
over ranks.

Counterpart of ``tensornetworks_tpu/runners/scale_distributed.py``. CLI:
``python -m tensornetworks_tpu_torch.runners.cli scale --qubits N --mesh D
[--dist-backend nccl|gloo] ...``. Called outside a distributed world, the
runner starts D ranks (``parallel.launch.spawn``) and returns rank 0's
summary; called on a rank (under ``torchrun``, whose world it joins, or
inside a spawned rank) it runs as that rank and returns the engine too.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..engines.distributed import DistributedQuantumKSDVariationalInference
from ..ops.hamming import resolve_length_scale
from ..parallel.launch import gather_reports, join_launcher_world, spawn
from .scale import make_scale_problem, phase_resume_paths, remove_phase_snapshots


def run_distributed_scale_experiment(num_qubits: int = 8, layers: int = 4,
                                     num_epochs: int = 200, lr: float = 5e-3, seed: int = 0,
                                     ansatz: str = "hardware_efficient",
                                     num_devices: Optional[int] = None,
                                     chunk_epochs: Optional[int] = None, verbose: bool = True,
                                     track_tvd: Optional[bool] = None, lr_phases=None,
                                     length_scale="auto", resume_state_path: Optional[str] = None,
                                     device="cuda", dist_backend: Optional[str] = None):
    """``lr_phases``: LR-annealed warm restarts, as in the single-device
    runner (each phase restarts the cosine schedule from the previous
    phase's end; the across-phase best is restored). ``resume_state_path``
    (needs ``chunk_epochs``): the engine's durable per-chunk resume, one
    snapshot per phase as ``run_scale_experiment`` keeps them.

    Outside a world: ``num_devices`` ranks (default: every card, or one CPU
    rank) on ``dist_backend`` (default: nccl on CUDA, gloo on the CPU);
    returns ``history``,
    ``num_qubits``, ``best_tvd``, ``best_epoch``, ``params`` and
    ``best_params`` (on the CPU) and ``ranks``, each rank's
    ``launch.rank_report``. On a rank: ``history``, ``model``,
    ``num_qubits``."""
    kwargs = dict(num_qubits=num_qubits, layers=layers, num_epochs=num_epochs, lr=lr, seed=seed,
                  ansatz=ansatz, num_devices=num_devices, chunk_epochs=chunk_epochs,
                  verbose=verbose, track_tvd=track_tvd, lr_phases=lr_phases,
                  length_scale=length_scale, resume_state_path=resume_state_path, device=device)
    if join_launcher_world(dist_backend, device):
        return _run_as_rank(**kwargs)
    world = num_devices or (torch.cuda.device_count() if torch.device(device).type == "cuda"
                            else 1)
    return spawn(_spawned_rank, world, dist_backend, device, kwargs)


def _spawned_rank(kwargs: dict) -> dict:
    out = _run_as_rank(**kwargs)
    model = out["model"]
    return {"history": out["history"], "num_qubits": out["num_qubits"],
            "best_tvd": model.best_tvd_, "best_epoch": model.best_epoch_,
            "params": model.params.cpu(), "best_params": model.best_params_.cpu(),
            "ranks": gather_reports(model.device)}


def _run_as_rank(num_qubits, layers, num_epochs, lr, seed, ansatz, num_devices, chunk_epochs,
                 verbose, track_tvd, lr_phases, length_scale, resume_state_path, device):
    bn, latent, observed = make_scale_problem(num_qubits, seed)
    if track_tvd is None:
        track_tvd = num_qubits <= 20
    posterior = bn.posterior_vector(latent, observed) if track_tvd else None
    model = DistributedQuantumKSDVariationalInference(
        bn, latent, list(observed.keys()), qbm_num_latent_vars=num_qubits,
        qbm_ansatz_layers=layers, qbm_ansatz_type=ansatz, qbm_init_method="small_random",
        seed=seed, num_devices=num_devices, base_kernel_length_scale=length_scale,
        device=device)
    verbose = verbose and dist.get_rank() == 0
    if verbose:
        print(f"mesh: {model.mesh.mesh.numel()} ranks, per-rank state = "
              f"2^{num_qubits}/{model.mesh.mesh.shape[1]}")
    phases = list(lr_phases) if lr_phases else [(num_epochs, lr)]
    resume_paths = phase_resume_paths(resume_state_path, len(phases))
    best_tvd, best_params = np.inf, None
    for phase, resume_path in zip(phases, resume_paths):
        if len(phase) == 3:
            p_epochs, p_lr, p_ls = phase
            model.base_kernel_length_scale = resolve_length_scale(p_ls, num_qubits)
        else:
            p_epochs, p_lr = phase
        history = model.train(observed, num_epochs=int(p_epochs), lr_born_machine=float(p_lr),
                              verbose=verbose, true_posterior_for_tvd=posterior,
                              gradient_clip_norm=10.0, chunk_epochs=chunk_epochs,
                              resume_state_path=resume_path,
                              keep_resume_state=len(phases) > 1)
        if posterior is not None and model.best_tvd_ < best_tvd:
            best_tvd, best_params = model.best_tvd_, model.best_params_
        if verbose and len(phases) > 1:
            print(f"phase ({int(p_epochs)} epochs @ lr {p_lr}): best TVD {model.best_tvd_:.6f}")
    if dist.get_rank() == 0:
        remove_phase_snapshots(resume_paths)
    if best_params is not None:
        model.params = best_params
        model.best_params_ = best_params
        model.best_tvd_ = best_tvd
    if verbose and track_tvd:
        tvds = np.asarray(history["tvd"], dtype=float)
        finite = tvds[np.isfinite(tvds)]
        if finite.size:
            print(f"{num_qubits}-qubit distributed ksd: final TVD {finite[-1]:.6f}, "
                  f"best {finite.min():.6f}")
    return {"history": history, "model": model, "num_qubits": num_qubits}
