"""Adversarial (prior-contrastive) variational inference.

Counterpart of ``tensornetworks_tpu/engines/advi.py``. An MLP discriminator
learns to tell Born-machine samples (label 1) from prior samples (label 0);
the Born machine is trained by REINFORCE on the reward
``r = logit_d(z, x) - log p(x|z)`` with a baseline. As in the port's KSD
engine, the epochs are an eager loop whose state stays on the device; the
host waits for it only at chunk ends.

Per epoch, following the JAX engine:
- ``k_classifier_steps`` discriminator steps: a batch from the Born machine
  (sampled from ``(p + 1e-10)/Σ``) and one from the prior (from
  ``clip(prior, 1e-30)``), the stable BCE-with-logits, a guarded update
  (BatchNorm statistics move even on a skipped step). Its gradient is
  σ(l) - y everywhere; at a logit of exactly 0 (a zero input at init, no
  conditioning) the JAX form's subgradients give -y instead;
- ``k_born_steps`` REINFORCE steps: the surrogate
  ``mean(log q·sg(r - b) + 0.01·log q)``, where the baseline b is the batch
  mean of r at epoch 0 and an EMA with ``baseline_decay`` after that; the
  same forward (so, for a classical Born machine, the same dropout mask)
  serves the sample and its ``log q``;
- the TVD after the update, with a best snapshot of both networks that is
  restored at the end.
``log p(x|z)`` is a precomputed ``2^n`` table with the reference's ±inf
edges where the prior is below 1e-9, clipped to ±``log_p_floor`` when that
is given. Sampling is ``torch.multinomial`` with replacement from one
generator per run, or the ``sampler`` the caller passes.

A quantum Born machine's θ does not change during the discriminator phase,
so its distribution is computed once per epoch (with autograd, for the
REINFORCE step) and serves every sample of the epoch; that forward at the
epoch's start is also the previous epoch's post-update evaluation, and one
forward after the loop covers the last epoch. The JAX engine runs k_D + 2
forwards per epoch for the same values.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core.bayes_net import BayesianNetwork
from ..core.bits import generate_all_binary_outcomes, torch_index_to_bits
from ..models.born_classical import ClassicalBornMachine
from ..models.classifier import BinaryClassifierMLP
from ..train import profile_trace, save_checkpoint, training_bundle
from .common import global_norm, guarded_update, make_optimizer
from .ksd import (_load_chunk_state, _posterior_vec_from, _resume_fingerprint,
                  _save_chunk_state, steady_epochs_per_sec)


def multinomial_sampler(probs: torch.Tensor, num_samples: int,
                        generator: torch.Generator) -> torch.Tensor:
    """``num_samples`` outcome indices drawn with replacement from ``probs``
    (non-negative, not necessarily normalised)."""
    return torch.multinomial(probs, num_samples, replacement=True, generator=generator)


class AdversarialVariationalInference:
    """``born_machine_config`` builds a ``ClassicalBornMachine`` (its
    ``init_method`` replaced by ``small_random``); or pass a ready model as
    ``born_machine`` (a ``QuantumBornMachine``). ``classifier_config`` goes to
    ``BinaryClassifierMLP``, whose input is z, or ``concat(z, x)`` for a
    conditional Born machine. ``device`` defaults to the card."""

    def __init__(self, bayesian_network: BayesianNetwork, latent_vars_names: Sequence[str],
                 observed_vars_names: Sequence[str], born_machine_config: Optional[dict] = None,
                 classifier_config: Optional[dict] = None, dtype=torch.float32, seed: int = 0,
                 born_machine=None, device="cuda"):
        self.bn = bayesian_network
        self.latent_vars_names = list(latent_vars_names)
        self.observed_vars_names = list(observed_vars_names)
        self.num_latent_vars = len(latent_vars_names)
        self.num_observed_vars = len(observed_vars_names)
        self.dtype = dtype
        self.seed = seed
        self.device = torch.device(device)

        born_machine_config = dict(born_machine_config or {})
        if born_machine is not None:
            self.born_machine = born_machine
        else:
            born_machine_config = {**born_machine_config, "init_method": "small_random"}
            self.born_machine = ClassicalBornMachine(self.num_latent_vars, dtype=dtype,
                                                     device=device, **born_machine_config)
        self.is_classical = isinstance(self.born_machine, ClassicalBornMachine)
        self.classifier_input_dim = (self.num_latent_vars
                                     + born_machine_config.get("conditioning_dim", 0))
        self.classifier = BinaryClassifierMLP(self.classifier_input_dim, dtype=dtype,
                                              device=device, **dict(classifier_config or {}))

        gen = torch.Generator().manual_seed(seed)
        self.born_params = self.born_machine.init(gen)
        self.classifier_params, self.classifier_stats = self.classifier.init(gen)

        prior = self.bn.marginal_table(self.latent_vars_names)
        s = prior.sum()
        if s > 0 and not np.isclose(s, 1.0):
            prior = prior / s
        self.prior_z_probs = prior
        self.prior_z_dist_dict = {
            t: float(prior[i])
            for i, t in enumerate(generate_all_binary_outcomes(self.num_latent_vars))}
        self.history_: Optional[dict] = None
        self._x_condition = None

    def _log_p_x_given_z_table(self, x_observation_dict) -> np.ndarray:
        """Dense log p(x|z) over all 2^n z, float64: log(p(x, z)/p(z) + 1e-9),
        and where p(z) < 1e-9, +inf if p(x, z) > 1e-9 else -inf."""
        joint = self.bn.conditional_joint_table(self.latent_vars_names, x_observation_dict)
        prior = np.asarray(self.prior_z_probs, dtype=np.float64)
        low_prior = prior < 1e-9
        out = np.log(np.where(low_prior, 1.0, joint / np.where(low_prior, 1.0, prior)) + 1e-9)
        out[low_prior & (joint > 1e-9)] = np.inf
        out[low_prior & (joint <= 1e-9)] = -np.inf
        return out

    def train(self, x_observation_dict: Dict[str, int], num_epochs: int, batch_size: int,
              lr_born_machine: float, lr_classifier: float, k_classifier_steps: int = 1,
              k_born_steps: int = 1, verbose: bool = True, true_posterior_for_tvd=None,
              use_lr_scheduler: bool = True, gradient_clip_norm: float = 10.0,
              baseline_decay: float = 0.99, optimizer_type: str = "adam",
              adam_betas=(0.9, 0.999), seed: Optional[int] = None,
              checkpoint_path: Optional[str] = None, profile_dir: Optional[str] = None,
              chunk_epochs: Optional[int] = None, resume_state_path: Optional[str] = None,
              fail_after_chunks: Optional[int] = None, log_p_floor: Optional[float] = None,
              sampler: Callable = multinomial_sampler,
              keep_resume_state: bool = False) -> dict:
        """``chunk_epochs``: host sync after every chunk (per-chunk wall
        times give the steady rate); the results are the same. ``seed``
        overrides the engine's seed for the run's generator (dropout and
        sampling). ``sampler(probs, num_samples, generator)`` returns indices;
        per epoch it is called, in order, for each discriminator step's Born
        batch and prior batch, then for each REINFORCE step's batch.

        ``resume_state_path`` (needs ``chunk_epochs``): durable per-chunk
        resume, as ``run_ksd_scan``'s. The snapshot holds both parameter
        sets with their Adam states, the discriminator's BatchNorm
        statistics, the REINFORCE baseline, the best snapshots, the history
        so far and the run's generator state; a resumed run is bit-identical
        to an uninterrupted one. On CUDA this holds only with
        ``torch.use_deterministic_algorithms(True)`` (and
        ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before CUDA starts) around
        both runs: the backward of the REINFORCE log q gather is an atomic
        scatter there, whose sums vary from run to run. It is removed at the end unless
        ``keep_resume_state``. ``fail_after_chunks``: raise ``RuntimeError``
        after saving that many chunks of this call (fault injection).
        ``checkpoint_path``: at the end, ``{"born": training_bundle(born
        params), "classifier": {"params", "batch_stats"}, "best_tvd"}``, the
        JAX engine's layout. ``profile_dir``: a ``torch.profiler`` trace."""
        if resume_state_path and not chunk_epochs:
            raise ValueError("resume_state_path requires chunk_epochs")
        if self.num_observed_vars > 0 and set(x_observation_dict) != set(self.observed_vars_names):
            raise ValueError("Keys in x_observation_dict must match self.observed_vars_names.")
        n, dtype, dev = self.num_latent_vars, self.dtype, self.device
        x_obs = torch.tensor([float(x_observation_dict[nm]) for nm in self.observed_vars_names],
                             dtype=dtype, device=dev)
        x_cond = None
        if self.is_classical and self.born_machine.conditioning_dim > 0:
            if self.num_observed_vars == 0:
                raise ValueError("Born machine is conditional but no observed vars specified.")
            if self.born_machine.conditioning_dim != self.num_observed_vars:
                raise ValueError("Born machine conditioning_dim must match num_observed_vars.")
            x_cond = x_obs
        self._x_condition = x_cond
        include_x = (self.num_observed_vars > 0
                     and self.classifier_input_dim == n + self.num_observed_vars)
        log_p_np = self._log_p_x_given_z_table(x_observation_dict)
        if log_p_floor is not None:
            log_p_np = np.clip(log_p_np, -log_p_floor, log_p_floor)
        log_p_table = torch.as_tensor(log_p_np, dtype=dtype, device=dev)
        posterior_vec = _posterior_vec_from(true_posterior_for_tvd, n, dtype, dev)
        track = posterior_vec is not None
        prior_w = torch.as_tensor(np.clip(self.prior_z_probs, 1e-30, None), dtype=dtype,
                                  device=dev)

        opt_born = make_optimizer(optimizer_type, lr_born_machine, num_epochs, use_lr_scheduler,
                                  adam_betas, gradient_clip_norm, steps_per_epoch=k_born_steps)
        opt_clf = make_optimizer(optimizer_type, lr_classifier, num_epochs, use_lr_scheduler,
                                 adam_betas, gradient_clip_norm,
                                 steps_per_epoch=k_classifier_steps)
        bm, clf = self.born_machine, self.classifier
        gen = torch.Generator(device=dev).manual_seed(self.seed if seed is None else seed)
        labels = torch.cat([torch.ones(batch_size, 1, dtype=dtype, device=dev),
                            torch.zeros(batch_size, 1, dtype=dtype, device=dev)])

        def forward(bp, train):
            if self.is_classical:
                return bm.probs(bp, x_cond, train=train, generator=gen if train else None)
            return bm.probs(bp).to(dtype)

        def sampling_probs(p):
            pp = p.detach() + 1e-10
            return pp / pp.sum()

        def clf_input(idx):
            z = torch_index_to_bits(idx, n, dtype)
            return torch.cat([z, x_obs.expand(z.shape[0], -1)], dim=1) if include_x else z

        bp, cp = self.born_params.clone(), self.classifier_params.clone()
        stats = self.classifier_stats
        bo, co = opt_born.init(bp), opt_clf.init(cp)
        baseline = torch.zeros((), dtype=dtype, device=dev)
        best_tvd = torch.tensor(float("inf"), dtype=dtype, device=dev)
        best_epoch = torch.tensor(-1, dtype=torch.int64, device=dev)
        best_bp, best_cp, best_stats = bp, cp, stats
        best_probs = forward(bp, False).detach()
        hist = torch.full((5, num_epochs), float("nan"), dtype=dtype, device=dev)

        def take_best(q, epoch):
            nonlocal best_tvd, best_epoch, best_bp, best_cp, best_stats, best_probs
            tvd = 0.5 * (q - posterior_vec).abs().sum()
            improved = tvd < best_tvd
            best_tvd = torch.where(improved, tvd, best_tvd)
            best_epoch = torch.where(improved, torch.full_like(best_epoch, epoch), best_epoch)
            best_bp = torch.where(improved, bp, best_bp)
            best_cp = torch.where(improved, cp, best_cp)
            if stats is not None:
                best_stats = torch.where(improved, stats, best_stats)
            best_probs = torch.where(improved, q, best_probs)
            return tvd

        chunk = chunk_epochs or num_epochs

        def carry(end):
            state = {"bp": bp, "cp": cp, "baseline": baseline, "best_tvd": best_tvd,
                     "best_epoch": best_epoch, "best_bp": best_bp, "best_cp": best_cp,
                     "best_probs": best_probs, "hist": hist[:, :end],
                     **{f"bo_{k}": v for k, v in bo.items()},
                     **{f"co_{k}": v for k, v in co.items()}}
            if stats is not None:
                state.update(stats=stats, best_stats=best_stats)
            return state

        first = 0
        if resume_state_path:
            fingerprint = _resume_fingerprint(carry(num_epochs), (gen,), num_epochs, chunk)
            if os.path.exists(resume_state_path):
                saved, first = _load_chunk_state(resume_state_path, fingerprint, (gen,), dev)
                bp, cp, baseline = saved["bp"], saved["cp"], saved["baseline"]
                best_tvd, best_epoch = saved["best_tvd"], saved["best_epoch"]
                best_bp, best_cp, best_probs = saved["best_bp"], saved["best_cp"], saved["best_probs"]
                bo = {k: saved[f"bo_{k}"] for k in bo}
                co = {k: saved[f"co_{k}"] for k in co}
                if stats is not None:
                    stats, best_stats = saved["stats"], saved["best_stats"]
                hist[:, :first] = saved["hist"]
        chunk_seconds = []
        t0 = time.perf_counter()
        with profile_trace(profile_dir):
            for start in range(first, num_epochs, chunk):
                t_chunk = time.perf_counter()
                for epoch in range(start, min(start + chunk, num_epochs)):
                    if not self.is_classical:
                        # θ is fixed until the REINFORCE step: one forward for
                        # the epoch's samples and its gradient, which is also the
                        # previous epoch's post-update distribution.
                        p_req = bp.detach().requires_grad_(True)
                        q = forward(p_req, True)
                        q_sample = sampling_probs(q)
                        if track and epoch > 0:
                            hist[2, epoch - 1] = take_best(q.detach(), epoch - 1)

                    loss_d = torch.zeros((), dtype=dtype, device=dev)
                    gnorm_d = torch.zeros((), dtype=dtype, device=dev)
                    for _ in range(k_classifier_steps):
                        if self.is_classical:
                            with torch.no_grad():
                                idx_q = sampler(sampling_probs(forward(bp, True)), batch_size, gen)
                        else:
                            idx_q = sampler(q_sample, batch_size, gen)
                        idx_p = sampler(prior_w, batch_size, gen)
                        inputs = torch.cat([clf_input(idx_q), clf_input(idx_p)])
                        c_req = cp.detach().requires_grad_(True)
                        logits, new_stats = clf.logits(c_req, inputs, stats, train=True)
                        loss_d = F.binary_cross_entropy_with_logits(logits, labels)
                        (grads,) = torch.autograd.grad(loss_d, c_req)
                        gnorm_d = global_norm([grads])
                        cp, co = guarded_update(opt_clf, grads, co, cp, torch.isfinite(loss_d))
                        stats = new_stats
                        loss_d = loss_d.detach()

                    loss_q = torch.full((), float("nan"), dtype=dtype, device=dev)
                    gnorm_q = torch.zeros((), dtype=dtype, device=dev)
                    for step in range(k_born_steps):
                        if self.is_classical or step > 0:
                            p_req = bp.detach().requires_grad_(True)
                            q = forward(p_req, True)
                            q_sample = sampling_probs(q)
                        idx = sampler(q_sample, batch_size, gen)
                        with torch.no_grad():
                            logit_vals = clf.logits(cp, clf_input(idx), stats)[0][:, 0]
                            raw_reward = logit_vals - log_p_table[idx]
                            batch_mean = raw_reward.mean()
                            baseline = (batch_mean if epoch == 0 else
                                        baseline_decay * baseline + (1 - baseline_decay) * batch_mean)
                            advantage = raw_reward - baseline
                        log_q = torch.log(q.clamp(min=1e-10))[idx]
                        loss_q = (log_q * advantage + 0.01 * log_q).mean()
                        (grads,) = torch.autograd.grad(loss_q, p_req)
                        gnorm_q = global_norm([grads])
                        bp, bo = guarded_update(opt_born, grads, bo, bp, torch.isfinite(loss_q))
                        loss_q = loss_q.detach()

                    if track and self.is_classical:
                        with torch.no_grad():
                            hist[2, epoch] = take_best(forward(bp, False), epoch)
                    hist[[0, 1, 3, 4], epoch] = torch.stack([loss_d, loss_q, gnorm_q, gnorm_d])
                best_tvd.item()  # host sync closes the chunk
                end = min(start + chunk, num_epochs)
                chunk_seconds.append((end - start, time.perf_counter() - t_chunk))
                if resume_state_path:
                    _save_chunk_state(resume_state_path, carry(end), (gen,), end, fingerprint)
                if fail_after_chunks is not None and len(chunk_seconds) >= fail_after_chunks:
                    raise RuntimeError(f"fault injection: killed after {len(chunk_seconds)} chunks")
            if resume_state_path and not keep_resume_state and os.path.exists(resume_state_path):
                os.remove(resume_state_path)
            if track and not self.is_classical:
                with torch.no_grad():
                    hist[2, num_epochs - 1] = take_best(forward(bp, False), num_epochs - 1)
        elapsed = time.perf_counter() - t0

        loss_d_h, loss_q_h, tvd_h, gq_h, gd_h = hist.cpu().numpy()
        history = {"loss_classifier": loss_d_h.tolist(), "loss_born_machine": loss_q_h.tolist(),
                   "tvd": tvd_h.tolist(), "grad_norm_born": gq_h.tolist(),
                   "grad_norm_classifier": gd_h.tolist()}
        dispatched = sum(e for e, _ in chunk_seconds)
        history["epochs_dispatched"] = dispatched
        history["epochs_per_sec"] = dispatched / elapsed if elapsed > 0 else float("inf")
        history["train_seconds"] = elapsed
        steady = steady_epochs_per_sec(chunk_seconds)
        if steady is not None:
            history["epochs_per_sec_steady"] = steady
        self.history_ = history
        self.born_params, self.classifier_params, self.classifier_stats = bp, cp, stats
        self.best_tvd_ = float(best_tvd)
        self.best_epoch_ = int(best_epoch)
        if track and np.isfinite(self.best_tvd_):
            if verbose:
                print(f"Restoring best parameters (TVD: {self.best_tvd_:.6f})")
            self.born_params = best_bp
            self.classifier_params, self.classifier_stats = best_cp, best_stats
        if checkpoint_path:
            classifier = {"params": self.classifier_params}
            if self.classifier_stats is not None:
                classifier["batch_stats"] = self.classifier_stats
            save_checkpoint(checkpoint_path, {
                "born": training_bundle(self.born_params), "classifier": classifier,
                "best_tvd": torch.tensor(self.best_tvd_, dtype=dtype)})
        if verbose:
            print(f"Adversarial training: {dispatched} epochs in {elapsed:.3f}s "
                  f"({history['epochs_per_sec']:.1f} epochs/s)")
        return history

    def get_prob_dict(self, x_condition=None) -> dict:
        if self.is_classical:
            return self.born_machine.get_prob_dict(
                self.born_params, self._x_condition if x_condition is None else x_condition)
        return self.born_machine.get_prob_dict(self.born_params)
