"""Amortized KSD over a batch of observations, and K independent KSD
replicas in one loop.

Counterpart of ``tensornetworks_tpu/engines/amortized.py``:

- ``AmortizedKSD``: one conditional Born machine (classical MLP, or a
  conditioned ``QuantumBornMachine``) trained against every observation x
  at once, ``loss = mean_x [sqrt(clamp(q_xᵀ K_x q_x, 1e-12)) − w·H(q_x)]``
  with one ``SteinOperator`` per observation (the dense Gram up to 12
  variables, the gcorr operator above: its stein2d kernel and the
  stein_gcorr recombination).
- ``train_multi_seed``: K independent quantum-KSD replicas of one
  observation, each with its own optimizer state, clip and NaN guard.

The JAX package vmaps the observations (and the replicas) into one XLA
program; here each observation's circuit is its own kernel launch per
direction, X launches of each circuit kernel and of each Stein kernel per
epoch. ``mesh=`` (a ``parallel.make_mesh`` mesh, every rank calling) splits
the observations, or the seeds, over the mesh's ``dp`` axis: each rank runs
its share through the kernels, X/dp launches an epoch.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.bayes_net import BayesianNetwork
from ..models.born_classical import ClassicalBornMachine
from ..models.born_quantum import QuantumBornMachine
from ..ops.hamming import resolve_length_scale
from ..ops.stein import SteinOperator, score_table
from .common import global_norm, guarded_update, highest_matmul_precision, make_optimizer
from .distill import batch_probs
from .ksd import steady_epochs_per_sec


def data_shard_list(items: list, mesh) -> list:
    """This rank's contiguous share of ``items`` over the mesh's ``dp`` axis
    (its length must divide by dp)."""
    from ..parallel.mesh import DATA_AXIS, axis_index, axis_size

    dp = axis_size(mesh, DATA_AXIS)
    if len(items) % dp:
        raise ValueError(f"{len(items)} items do not split over dp={dp}")
    share = len(items) // dp
    start = axis_index(mesh, DATA_AXIS) * share
    return items[start:start + share]


class AmortizedKSD:
    """Conditional-Born-machine KSD trained over a batch of observations.

    ``born_machine_config`` builds a conditional classical Born machine
    (``conditioning_dim`` = the number of observed variables, init
    ``small_random``); or pass a conditioned ``QuantumBornMachine`` as
    ``born_machine``, whose device and dtype the engine then takes. θ is
    drawn from ``seed`` on the host."""

    def __init__(self, bayesian_network: BayesianNetwork, latent_vars_names: Sequence[str],
                 observed_vars_names: Sequence[str], born_machine_config: Optional[dict] = None,
                 base_kernel_length_scale=1.0, dtype=torch.float32, seed: int = 0,
                 born_machine=None, device="cuda"):
        self.bn = bayesian_network
        self.latent_vars_names = list(latent_vars_names)
        self.observed_vars_names = list(observed_vars_names)
        self.num_latent_vars = len(latent_vars_names)
        self.length_scale = resolve_length_scale(base_kernel_length_scale, self.num_latent_vars)
        if born_machine is None:
            cfg = {**(born_machine_config or {}), "conditioning_dim": len(observed_vars_names),
                   "init_method": "small_random"}
            born_machine = ClassicalBornMachine(self.num_latent_vars, dtype=dtype, device=device,
                                                **cfg)
        self.born_machine = born_machine
        self.dtype = born_machine.dtype
        self.device = born_machine.device
        self.params = born_machine.init(torch.Generator().manual_seed(seed))
        self._ops: Dict[tuple, list] = {}

    def _x(self, observation: Dict[str, int]) -> List[float]:
        return [float(observation[k]) for k in self.observed_vars_names]

    def operators(self, observations: List[Dict[str, int]]) -> List[SteinOperator]:
        """One Stein operator per observation at the current length scale,
        built once per (observations, length scale)."""
        key = (tuple(tuple(sorted(o.items())) for o in observations), self.length_scale)
        if key not in self._ops:
            self._ops[key] = [
                SteinOperator(score_table(self.bn.conditional_joint_table(
                    self.latent_vars_names, obs)), self.num_latent_vars, self.length_scale,
                    dtype=self.dtype, device=self.device)
                for obs in observations]
        return self._ops[key]

    def _posteriors(self, observations) -> torch.Tensor:
        posts = []
        for obs in observations:
            t = self.bn.conditional_joint_table(self.latent_vars_names, obs)
            s = t.sum()
            posts.append(t / s if s > 0 else np.zeros_like(t))
        return torch.as_tensor(np.stack(posts), dtype=self.dtype, device=self.device)

    @highest_matmul_precision()
    def train(self, observations: List[Dict[str, int]], num_epochs: int = 0, lr: float = 3e-3,
              gradient_clip_norm: float = 5.0, entropy_weight: float = 1e-3,
              verbose: bool = True, seed: int = 0, mesh=None,
              chunk_epochs: Optional[int] = None, lr_phases=None) -> dict:
        """Train on all ``observations`` at once; restores the best-mean-TVD
        parameters.

        ``mesh``: every rank of ``mesh`` calls with the same observations
        and trains on its ``dp`` share of them (X must divide by dp); the
        loss and the TVD are means over all X, summed over the ranks by
        all-reduce, and so is the gradient, so every rank takes the step of
        the single-device run (a classical machine's dropout masks are drawn
        per rank, from ``seed``: with dropout the run is another draw).

        ``chunk_epochs``: host syncs every so many epochs (per-chunk wall
        times give ``epochs_per_sec_steady``); the results are the same.
        ``seed`` seeds the classical machine's dropout masks.

        ``lr_phases``: a list of ``(epochs, lr)`` or ``(epochs, lr,
        length_scale)``, LR-annealed warm restarts: each phase restarts the
        cosine schedule from the previous phase's best at its own peak LR
        (a length scale rebuilds the operators); overrides
        ``num_epochs``/``lr``. The history is the last phase's; the
        across-phase best is restored (``best_mean_tvd_``,
        ``best_params_``)."""
        if not lr_phases:
            return self._train_single(observations, num_epochs, lr, gradient_clip_norm,
                                      entropy_weight, verbose, seed, chunk_epochs, mesh)
        best_tvd, best_params = np.inf, None
        for phase in lr_phases:
            if len(phase) == 3:
                p_epochs, p_lr, p_ls = phase
                self.length_scale = resolve_length_scale(p_ls, self.num_latent_vars)
            else:
                p_epochs, p_lr = phase
            history = self._train_single(observations, int(p_epochs), float(p_lr),
                                         gradient_clip_norm, entropy_weight, verbose, seed,
                                         chunk_epochs, mesh)
            if self.best_mean_tvd_ < best_tvd:
                best_tvd, best_params = self.best_mean_tvd_, self.best_params_
            if verbose:
                print(f"phase ({int(p_epochs)} epochs @ lr {p_lr}, l={self.length_scale:.4g}): "
                      f"best mean TVD {self.best_mean_tvd_:.6f}")
        if best_params is not None:
            self.params = best_params
            self.best_params_ = best_params
            self.best_mean_tvd_ = best_tvd
        return history

    def _train_single(self, observations, num_epochs, lr, gradient_clip_norm, entropy_weight,
                      verbose, seed, chunk_epochs, mesh=None):
        total = len(observations)
        if mesh is not None:
            from ..parallel.comm import all_reduce, psum_replicated
            from ..parallel.mesh import DATA_AXIS

            observations = data_shard_list(observations, mesh)
        ops = self.operators(observations)
        posts = self._posteriors(observations)
        X = torch.tensor([self._x(o) for o in observations], dtype=self.dtype,
                         device=self.device)

        def mean_over_all(v, grad=False):
            """The mean over all X observations of per-observation values."""
            if mesh is None:
                return v.mean()
            part = v.sum() / total
            return (psum_replicated(part, mesh, DATA_AXIS) if grad
                    else all_reduce(part, mesh, DATA_AXIS))
        bm = self.born_machine
        optimizer = make_optimizer("adam", lr, num_epochs, gradient_clip_norm=gradient_clip_norm)
        # The quantum forward is deterministic: epoch t's loss forward is
        # epoch t-1's post-update distribution, so the TVD is read from it
        # (lagging one epoch) and the last epoch is evaluated after the loop.
        # The classical machine trains with dropout and keeps a separate
        # dropout-free eval forward after each update.
        reuse_eval = not isinstance(bm, ClassicalBornMachine)
        gen = (None if reuse_eval
               else torch.Generator(device=self.device).manual_seed(seed))

        def forward(p, train=False):
            if reuse_eval:
                return batch_probs(bm, p, X)
            return bm.probs(p, X, train=train, generator=gen)

        def mean_tvd(q):
            return mean_over_all(0.5 * (q - posts).abs().sum(dim=-1))

        params = self.params.detach().clone()
        opt_state = optimizer.init(params)
        dev = params.device
        hist = torch.full((4, num_epochs), float("nan"), dtype=params.dtype, device=dev)
        best_tvd = torch.tensor(float("inf"), dtype=params.dtype, device=dev)
        best_epoch = torch.tensor(-1, dtype=torch.int64, device=dev)
        best_params = params.clone()

        def take_best(tvd, epoch, candidate, improved):
            nonlocal best_tvd, best_epoch, best_params
            best_tvd = torch.where(improved, tvd, best_tvd)
            best_epoch = torch.where(improved, torch.full_like(best_epoch, epoch), best_epoch)
            best_params = torch.where(improved, candidate, best_params)

        chunked = bool(chunk_epochs) and chunk_epochs < num_epochs
        chunk = chunk_epochs if chunked else max(num_epochs, 1)
        chunk_seconds = []
        t0 = time.perf_counter()
        for start in range(0, num_epochs, chunk):
            t_chunk = time.perf_counter()
            for epoch in range(start, min(start + chunk, num_epochs)):
                p = params.detach().requires_grad_(True)
                q = forward(p, train=True)
                ksd = torch.stack([op.ksd_loss(qx) for op, qx in zip(ops, q)])
                ent = -(q * torch.log(q.clamp(min=1e-10))).sum(dim=-1)
                loss = mean_over_all(ksd - entropy_weight * ent, grad=True)
                (grads,) = torch.autograd.grad(loss, p)
                if mesh is not None:
                    grads = all_reduce(grads, mesh, DATA_AXIS)
                ok = torch.isfinite(loss)
                if reuse_eval:
                    tvd = mean_tvd(q.detach())
                    if epoch > 0:  # epoch 0's forward is the init, not a candidate
                        take_best(tvd, epoch - 1, params, tvd < best_tvd)
                    params, opt_state = guarded_update(optimizer, grads, opt_state, params, ok)
                else:
                    params, opt_state = guarded_update(optimizer, grads, opt_state, params, ok)
                    with torch.no_grad():
                        tvd = mean_tvd(forward(params))
                    take_best(tvd, epoch, params, tvd < best_tvd)
                hist[:, epoch] = torch.stack([loss.detach(), tvd, global_norm([grads]),
                                              (~ok).to(hist.dtype)])
            best_tvd.item()  # host sync closes the chunk
            chunk_seconds.append((min(chunk, num_epochs - start), time.perf_counter() - t_chunk))
        if reuse_eval and num_epochs:
            with torch.no_grad():
                tvd_last = mean_tvd(forward(params))
            take_best(tvd_last, num_epochs - 1, params, tvd_last < best_tvd)
            # hist[1][t] becomes epoch t's post-update TVD.
            hist[1] = torch.cat([hist[1, 1:], tvd_last[None]])
        hist = hist.cpu().numpy()
        elapsed = time.perf_counter() - t0

        self.best_mean_tvd_ = float(best_tvd)
        self.best_epoch_ = int(best_epoch)
        self.best_params_ = best_params
        self.params = best_params if np.isfinite(self.best_mean_tvd_) else params
        history = {"loss": hist[0], "mean_tvd": hist[1], "grad_norm": hist[2],
                   "num_skipped_updates": int(hist[3].sum()),
                   "epochs_per_sec": num_epochs / elapsed if elapsed > 0 else float("inf"),
                   "train_seconds": elapsed}
        steady = steady_epochs_per_sec(chunk_seconds) if chunked else None
        if steady is not None:
            history["epochs_per_sec_steady"] = steady
        if verbose:
            print(f"Amortized KSD over {len(observations)} observations: best mean TVD "
                  f"{self.best_mean_tvd_:.6f} (final {history['mean_tvd'][-1]:.6f})")
        return history

    @highest_matmul_precision()
    def posterior_for(self, observation: Dict[str, int]) -> torch.Tensor:
        """q(· | x) at the current parameters, dropout off."""
        x = torch.tensor(self._x(observation), dtype=self.dtype, device=self.device)
        with torch.no_grad():
            return self.born_machine.probs(self.params, x)


@highest_matmul_precision()
def train_multi_seed(bayesian_network: BayesianNetwork, latent_vars_names, observed_dict,
                     num_seeds: int = 4, ansatz_layers: int = 2,
                     ansatz_type: str = "hardware_efficient", num_epochs: int = 200,
                     lr: float = 5e-3, gradient_clip_norm: float = 10.0, base_seed: int = 0,
                     mesh=None, params0=None, dtype=torch.float32, device="cuda"):
    """K independent quantum-KSD replicas of one observation (ℓ = 1).

    Returns (final params (K, P), per-seed TVD history (epochs, K), per-seed
    loss history (epochs, K)); the TVD is taken on a second forward after
    each update. Replica k starts from ``params0[k]``, or from the Born
    machine's init drawn from seed ``base_seed + k``. Each replica has its
    own optimizer state, clip and NaN guard, so a diverged seed freezes
    alone, as K single-seed runs would. The Stein operator is the engines'
    ``SteinOperator`` (the dense Gram up to 12 variables, the gcorr form
    above), where the JAX function runs the 3n+1-column matvec from 13: the
    same quadratic form.

    ``mesh``: every rank of ``mesh`` calls with the same arguments and
    trains its ``dp`` share of the seeds (K must divide by dp); the seeds
    are independent, so only the results are gathered, and every rank
    returns all K."""
    n = len(latent_vars_names)
    bn = bayesian_network
    t = bn.conditional_joint_table(latent_vars_names, observed_dict)
    op = SteinOperator(score_table(t), n, 1.0, dtype=dtype, device=device)
    post = torch.as_tensor(t / t.sum(), dtype=dtype, device=device)
    qbm = QuantumBornMachine(n, ansatz_layers=ansatz_layers, ansatz_type=ansatz_type,
                             dtype=dtype, device=device)
    seeds = list(range(num_seeds))
    if mesh is not None:
        from ..parallel.comm import all_gather
        from ..parallel.mesh import DATA_AXIS

        seeds = data_shard_list(seeds, mesh)
    if params0 is None:
        params = [qbm.init(torch.Generator().manual_seed(base_seed + k)) for k in seeds]
    else:
        params0 = torch.as_tensor(params0, dtype=dtype, device=device)
        if params0.shape[0] != num_seeds:
            raise ValueError(f"params0 leading axis {params0.shape[0]} != num_seeds {num_seeds}")
        params = [params0[k].clone() for k in seeds]
    optimizer = make_optimizer("adam", lr, num_epochs, gradient_clip_norm=gradient_clip_norm)
    states = [optimizer.init(p) for p in params]
    losses = torch.empty((num_epochs, len(seeds)), dtype=dtype, device=device)
    tvds = torch.empty_like(losses)
    for epoch in range(num_epochs):
        for k in range(len(seeds)):
            p = params[k].detach().requires_grad_(True)
            loss = op.ksd_loss(qbm.probs(p))
            (grads,) = torch.autograd.grad(loss, p)
            params[k], states[k] = guarded_update(optimizer, grads, states[k], params[k],
                                                  torch.isfinite(loss))
            with torch.no_grad():
                tvds[epoch, k] = 0.5 * (qbm.probs(params[k]) - post).abs().sum()
            losses[epoch, k] = loss.detach()
    params = torch.stack(params)
    if mesh is not None:
        # (dp, K/dp, ...) in rank order: seed order.
        params = all_gather(params, mesh, DATA_AXIS).reshape(num_seeds, -1)
        tvds, losses = (all_gather(h, mesh, DATA_AXIS).permute(1, 0, 2).reshape(num_epochs, -1)
                        for h in (tvds, losses))
    return params, tvds.cpu().numpy(), losses.cpu().numpy()
