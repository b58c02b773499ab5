"""Exact KSD variational inference with a classical or a quantum Born
machine.

Counterpart of ``run_ksd_scan``, ``KSDVariationalInference`` and
``QuantumKSDVariationalInference`` in ``tensornetworks_tpu/engines/ksd.py``.
The JAX engine runs the epochs as one ``lax.scan``; here they are an eager
loop whose per-epoch state (parameters, optimizer moments, best snapshot,
history, the early-stop flag) stays on the device, so the host waits for
the device only at chunk ends.

Per epoch: ``loss = sqrt(clamp(qᵀ K_p q, 1e-12))`` (minus ``w·H(q)`` for
the classical engine), its gradient, clip → Adam/SGD with the per-epoch
cosine schedule, a guarded update that skips a non-finite loss together
with its schedule step, and the TVD to the exact posterior with a best-TVD
snapshot that is restored at the end (the classical engine also stops
early).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.bayes_net import BayesianNetwork
from ..core.bits import generate_all_binary_outcomes
from ..models.born_classical import ClassicalBornMachine
from ..models.born_quantum import QuantumBornMachine
from ..ops.hamming import resolve_length_scale
from ..ops.stein import SteinOperator, score_table
from ..sim.structured import latent_edges
from ..train import profile_trace, save_checkpoint, training_bundle
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


def _resume_fingerprint(carry: dict, generators, num_epochs: int, chunk_epochs: int) -> str:
    """The configuration a resume snapshot was written under: the epoch
    budget, the chunking, and the shape and dtype of every carried tensor
    and generator state. Resuming under another one would replay a stale
    carry, so it raises instead."""
    shapes = ";".join(f"{k}:{tuple(v.shape)}:{v.dtype}" for k, v in carry.items())
    gens = ";".join(f"{tuple(g.get_state().shape)}" for g in generators)
    return f"torch-v1|epochs={num_epochs}|chunk={chunk_epochs}|{shapes}|generators={gens}"


def _save_chunk_state(path: str, carry: dict, generators, next_start: int,
                      fingerprint: str) -> None:
    """The durable chunk-resume snapshot: every carried tensor moved to the
    CPU, the state of every generator the run draws from, the next epoch and
    the fingerprint, written with ``torch.save`` to ``path + ".tmp"`` and
    moved into place (a killed run never leaves a torn snapshot)."""
    payload = {"carry": {k: v.detach().cpu() for k, v in carry.items()},
               "generators": [g.get_state() for g in generators],
               "next_start": next_start, "fingerprint": fingerprint}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _load_chunk_state(path: str, fingerprint: str, generators, device):
    """Inverse of ``_save_chunk_state``: (carry on ``device``, next epoch),
    the generators set to their saved states. The round trip is bit-exact,
    so a resumed run replays an uninterrupted one. Raises ``ValueError`` for
    a snapshot written under another configuration."""
    data = torch.load(path, weights_only=True)
    saved = data.get("fingerprint")
    if saved != fingerprint:
        raise ValueError(
            f"resume snapshot {path!r} was written under a different configuration "
            f"(saved fingerprint {saved!r} != current {fingerprint!r}); delete it or "
            "restore the original configuration")
    for g, state in zip(generators, data["generators"]):
        g.set_state(state)
    return {k: v.to(device) for k, v in data["carry"].items()}, int(data["next_start"])


def run_ksd_scan(*, probs_fn, params0: torch.Tensor, op: SteinOperator, num_epochs: int,
                 optimizer, posterior_vec: Optional[torch.Tensor],
                 chunk_epochs: Optional[int] = None, entropy_weight: Optional[float] = None,
                 eval_probs_fn=None, noisy_eval: bool = False, early_stopping: bool = False,
                 patience: int = 200, min_epochs_before_stop: int = 300,
                 op_schedule=None, resume_state_path: Optional[str] = None,
                 fail_after_chunks: Optional[int] = None, generators=(),
                 keep_resume_state: bool = False) -> dict:
    """Train for ``num_epochs``; returns final/best params and the history.

    Two evaluation modes, as in the JAX engine:
    - ``eval_probs_fn=None`` (the quantum engine): the TVD evaluation reuses
      the loss forward (the JAX engine's ``reuse_loss_forward_for_eval``).
      ``probs_fn`` is deterministic, so epoch t's post-update distribution
      is epoch t+1's loss forward, and one extra forward after the loop
      covers the last epoch.
    - ``eval_probs_fn`` given (the classical engine, whose training forward
      has dropout): a separate forward after each update, ``eval_probs_fn``
      or, with ``noisy_eval``, ``probs_fn`` again. Only here can
      ``early_stopping`` stop the run: once the TVD has not improved for
      more than ``patience`` epochs after epoch ``min_epochs_before_stop``,
      every later epoch is frozen (no update, no new best).
    Either way the recorded TVD history and the best snapshot are those of
    evaluating after every update.

    ``entropy_weight``: the loss is ``ksd - w·H(q)`` (entropy clipped at
    1e-10) and the entropy is recorded; None trains on the KSD alone.

    ``chunk_epochs``: split the loop into chunks with a host sync after each
    (per-chunk wall times go to ``chunk_seconds``); the results are the same.
    The stop flag stays on the device and is read at a chunk's end, where a
    stopped run breaks: the history then ends there.

    ``op_schedule`` (needs ``chunk_epochs``): ``chunk_index -> SteinOperator``
    in place of ``op`` for that chunk's loss, the tempered-target hook (the
    JAX engine's ``stein_args_schedule``, which swaps the operator's jit
    arguments where this loop swaps the operator); it is indexed by the
    absolute chunk, so a resumed run trains each chunk against its target.

    ``resume_state_path`` (needs ``chunk_epochs``): durable resume. After
    every chunk the carry (parameters, optimizer state with its step count,
    best snapshot, early-stop state, the history so far) and the state of
    each of ``generators`` (the ``torch.Generator``s the forward draws from)
    are written there (``_save_chunk_state``); an existing snapshot is
    loaded first and its chunks skipped, so the run is bit-identical to an
    uninterrupted one. The snapshot is removed at the end, unless
    ``keep_resume_state`` (the scale runner keeps a finished phase's until
    its last phase ends). ``fail_after_chunks``: raise ``RuntimeError`` after
    saving that many chunks of this call (fault injection for the tests).
    Without a path there is no file I/O and no extra host sync.
    """
    if op_schedule is not None and not chunk_epochs:
        raise ValueError("op_schedule requires chunk_epochs")
    if resume_state_path and not chunk_epochs:
        raise ValueError("resume_state_path requires chunk_epochs")
    dev = params0.device
    params = params0.detach().clone()
    opt_state = optimizer.init(params)
    track = posterior_vec is not None
    reuse = eval_probs_fn is None
    rows = 4 + (entropy_weight is not None)
    hist = torch.full((rows, num_epochs), float("nan"), dtype=params.dtype, device=dev)
    best_tvd = torch.tensor(float("inf"), dtype=params.dtype, device=dev)
    best_epoch = torch.tensor(-1, dtype=torch.int64, device=dev)
    best_params = params.clone()
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    since_best = torch.zeros((), dtype=torch.int64, device=dev)
    stop_at = torch.full((), num_epochs, dtype=torch.int64, device=dev)

    def take_best(tvd, epoch, candidate, improved):
        nonlocal best_tvd, best_epoch, best_params
        best_tvd = torch.where(improved, tvd, best_tvd)
        best_epoch = torch.where(improved, torch.full_like(best_epoch, epoch), best_epoch)
        best_params = torch.where(improved, candidate, best_params)

    chunk = chunk_epochs or num_epochs

    def carry(end):
        return {"params": params, **{f"opt_{k}": v for k, v in opt_state.items()},
                "best_tvd": best_tvd, "best_epoch": best_epoch, "best_params": best_params,
                "stopped": stopped, "since_best": since_best, "stop_at": stop_at,
                "hist": hist[:, :end]}

    first = 0
    if resume_state_path:
        fingerprint = _resume_fingerprint(carry(num_epochs), generators, num_epochs, chunk)
        if os.path.exists(resume_state_path):
            saved, first = _load_chunk_state(resume_state_path, fingerprint, generators, dev)
            params, best_params = saved["params"], saved["best_params"]
            opt_state = {k: saved[f"opt_{k}"] for k in opt_state}
            best_tvd, best_epoch, stopped = saved["best_tvd"], saved["best_epoch"], saved["stopped"]
            since_best, stop_at = saved["since_best"], saved["stop_at"]
            hist[:, :first] = saved["hist"]
    end = first
    # A run that had stopped early when it was saved dispatches nothing more.
    last = first if (first and early_stopping and bool(stopped)) else num_epochs
    chunk_seconds = []
    for start in range(first, last, chunk):
        t_chunk = time.perf_counter()
        chunk_op = op if op_schedule is None else op_schedule(start // chunk)
        for epoch in range(start, min(start + chunk, num_epochs)):
            p = params.detach().requires_grad_(True)
            q = probs_fn(p)
            ksd = chunk_op.ksd_loss(q)
            loss = ksd
            if entropy_weight is not None:
                ent = -(q * torch.log(q.clamp(min=1e-10))).sum()
                loss = ksd - entropy_weight * ent
            (grads,) = torch.autograd.grad(loss, p)
            do_update = torch.isfinite(loss)
            if early_stopping:
                do_update = do_update & ~stopped
            tvd = torch.full_like(ksd, float("nan"))
            if track and reuse:
                # q at the current params is the previous epoch's post-update
                # distribution; epoch 0's is the init, not a candidate.
                tvd = 0.5 * (q.detach() - posterior_vec).abs().sum()
                if epoch > 0:
                    take_best(tvd, epoch - 1, params, tvd < best_tvd)
            params, opt_state = guarded_update(optimizer, grads, opt_state, params, do_update)
            if track and not reuse:
                with torch.no_grad():
                    q_eval = (probs_fn if noisy_eval else eval_probs_fn)(params)
                tvd = 0.5 * (q_eval - posterior_vec).abs().sum()
                improved = (tvd < best_tvd) & ~stopped
                take_best(tvd, epoch, params, improved)
                if early_stopping:
                    since_best = torch.where(stopped, since_best,
                                             torch.where(improved, 0, since_best + 1))
                    if epoch > min_epochs_before_stop:
                        newly = (since_best > patience) & ~stopped
                        stop_at = torch.where(newly, epoch + 1, stop_at)
                        stopped = stopped | newly
            skipped = (~do_update & ~stopped) if early_stopping else ~do_update
            row = [ksd.detach(), tvd, global_norm([grads]), skipped.to(hist.dtype)]
            if entropy_weight is not None:
                row.append(ent.detach())
            hist[:, epoch] = torch.stack(row)
        end = min(start + chunk, num_epochs)
        best_tvd.item()  # host sync closes the chunk
        chunk_seconds.append((end - start, time.perf_counter() - t_chunk))
        if resume_state_path:
            _save_chunk_state(resume_state_path, carry(end), generators, end, fingerprint)
        if fail_after_chunks is not None and len(chunk_seconds) >= fail_after_chunks:
            raise RuntimeError(f"fault injection: killed after {len(chunk_seconds)} chunks")
        if early_stopping and bool(stopped):
            break  # every later epoch would be a frozen no-op
    if resume_state_path and not keep_resume_state and os.path.exists(resume_state_path):
        os.remove(resume_state_path)

    with torch.no_grad():
        if track and reuse:
            # The last epoch's post-update evaluation; shift the history so
            # hist[t] is epoch t's post-update TVD.
            tvd_last = 0.5 * (probs_fn(params) - posterior_vec).abs().sum()
            take_best(tvd_last, num_epochs - 1, params, tvd_last < best_tvd)
            hist[1] = torch.cat([hist[1, 1:], tvd_last[None]])
        best_probs = (probs_fn if reuse else eval_probs_fn)(best_params)
    hist = hist[:, :end].cpu().numpy()
    out = {
        "params": params,
        "best_tvd": float(best_tvd),
        "best_epoch": int(best_epoch),
        "best_params": best_params,
        "best_probs": best_probs,
        "loss_ksd": hist[0],
        "tvd": hist[1],
        "grad_norm": hist[2],
        "skipped": hist[3],
        "stop_epoch": int(stop_at),
        "epochs_dispatched": end - first,
        "chunk_seconds": chunk_seconds,
    }
    if entropy_weight is not None:
        out["entropy"] = hist[4]
    return out


def steady_epochs_per_sec(chunk_seconds) -> Optional[float]:
    """Epoch rate over every chunk after the first (which pays the one-time
    kernel build and warm-up); None with fewer than two chunks."""
    if not chunk_seconds or len(chunk_seconds) < 2:
        return None
    sec = sum(s for _, s in chunk_seconds[1:])
    return sum(e for e, _ in chunk_seconds[1:]) / sec if sec > 0 else None


def not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to the PyTorch package yet "
                              f"(ROADMAP {item})")


class KSDVariationalInference:
    """Classical-Born-machine KSD engine (``ClassicalBornMachine``, table or
    conditional MLP). ``device`` defaults to the card; the config's
    ``init_method`` is replaced by ``small_random``, as in the JAX engine.

    Per epoch: the loss ``ksd - w·H(q)`` on the training forward (dropout on,
    masks from one generator per run), its gradient, the guarded update,
    then the TVD on a separate forward after the update, with early
    stopping (``run_ksd_scan``). At the end the best distribution is
    restored in fixed-probs mode and checked: a restored TVD more than 1e-6
    from the best one prints a warning."""

    def __init__(self, bayesian_network: BayesianNetwork, latent_vars_names: Sequence[str],
                 observed_vars_names: Sequence[str], born_machine_config: dict,
                 base_kernel_length_scale=1.0, dtype=torch.float32,
                 dense: Optional[bool] = None, seed: int = 0, device="cuda"):
        self.bn = bayesian_network
        self.latent_vars_names = list(latent_vars_names)
        self.observed_vars_names = list(observed_vars_names)
        self.num_latent_vars = len(latent_vars_names)
        self.num_observed_vars = len(observed_vars_names)
        self.base_kernel_length_scale = resolve_length_scale(
            base_kernel_length_scale, self.num_latent_vars)
        self.dtype = dtype
        self.dense = dense
        self.seed = seed
        self.device = torch.device(device)
        born_machine_config = {**born_machine_config, "init_method": "small_random"}
        self.born_machine = ClassicalBornMachine(self.num_latent_vars, dtype=dtype,
                                                 device=device, **born_machine_config)
        self.params = self.born_machine.init(torch.Generator().manual_seed(seed))
        self._x_condition = None
        self.history_: Optional[dict] = None

    def _x_cond_tensor(self, x_observation_dict):
        if self.num_observed_vars == 0:
            return None
        if set(x_observation_dict) != set(self.observed_vars_names):
            raise ValueError("Keys in x_observation_dict must match self.observed_vars_names.")
        if self.born_machine.conditioning_dim == 0:
            return None
        if self.born_machine.conditioning_dim != self.num_observed_vars:
            raise ValueError("Born machine conditioning_dim must match num_observed_vars.")
        return torch.tensor([float(x_observation_dict[n]) for n in self.observed_vars_names],
                            dtype=self.dtype, device=self.device)

    def build_operator(self, x_observation_dict) -> SteinOperator:
        t = self.bn.conditional_joint_table(self.latent_vars_names, x_observation_dict)
        return SteinOperator(score_table(t), self.num_latent_vars,
                             self.base_kernel_length_scale, dtype=self.dtype,
                             dense=self.dense, device=self.device)

    def train(self, x_observation_dict: Dict[str, int], num_epochs: int,
              lr_born_machine: float, verbose: bool = True, true_posterior_for_tvd=None,
              use_lr_scheduler: bool = True, gradient_clip_norm: float = 10.0,
              optimizer_type: str = "adam", adam_betas=(0.9, 0.999),
              entropy_weight: float = 0.01, patience: int = 200, seed: Optional[int] = None,
              checkpoint_path: Optional[str] = None, profile_dir: Optional[str] = None,
              chunk_epochs: Optional[int] = None, resume_state_path: Optional[str] = None,
              eval_convention: str = "deterministic") -> dict:
        """``eval_convention``: ``"deterministic"`` (TVD on the dropout-free
        forward) or ``"train_noisy"`` (the reference's: TVD on a forward with
        dropout on). ``chunk_epochs`` defaults to 100 when the TVD is
        tracked, so that an early-stopped run breaks soon after its stop;
        the results do not depend on it. ``seed`` overrides the engine's
        seed for the dropout generator.

        ``resume_state_path`` (needs ``chunk_epochs``): durable per-chunk
        resume (``run_ksd_scan``), the dropout generator's state included.
        ``checkpoint_path``: at the end, ``training_bundle(params,
        best_params, best_tvd, epoch=stop epoch)`` by ``save_checkpoint``.
        ``profile_dir``: a ``torch.profiler`` trace of the run
        (``train.profile_trace``)."""
        if resume_state_path and not chunk_epochs:
            raise ValueError("resume_state_path requires chunk_epochs")
        if eval_convention not in ("deterministic", "train_noisy"):
            raise ValueError(f"unknown eval_convention {eval_convention!r}")
        noisy_eval = eval_convention == "train_noisy"
        # A later run trains the parameters again, not the distribution an
        # earlier run restored (fixed probs have no gradient).
        self.born_machine.clear_fixed_probs()
        x_cond = self._x_cond_tensor(x_observation_dict)
        self._x_condition = x_cond
        op = self.build_operator(x_observation_dict)
        posterior_vec = _posterior_vec_from(true_posterior_for_tvd, self.num_latent_vars,
                                            self.dtype, self.device)
        track = posterior_vec is not None
        optimizer = make_optimizer(optimizer_type, lr_born_machine, num_epochs,
                                   use_lr_scheduler, adam_betas, gradient_clip_norm)
        bm = self.born_machine
        gen = torch.Generator(device=self.device).manual_seed(self.seed if seed is None else seed)
        if chunk_epochs is None and track:
            chunk_epochs = 100

        t0 = time.perf_counter()
        with profile_trace(profile_dir):
            out = run_ksd_scan(
                probs_fn=lambda p: bm.probs(p, x_cond, train=True, generator=gen),
                eval_probs_fn=lambda p: bm.probs(p, x_cond), params0=self.params, op=op,
                num_epochs=num_epochs, optimizer=optimizer, posterior_vec=posterior_vec,
                chunk_epochs=chunk_epochs, entropy_weight=entropy_weight,
                noisy_eval=noisy_eval, early_stopping=track, patience=patience,
                resume_state_path=resume_state_path, generators=(gen,))
        elapsed = time.perf_counter() - t0

        stop_epoch = out["stop_epoch"]
        self.params = out["params"]
        self.best_params_ = out["best_params"]
        self.best_tvd_ = out["best_tvd"]
        self.best_epoch_ = out["best_epoch"]
        history = {k: out[k][:stop_epoch].tolist()
                   for k in ("loss_ksd", "tvd", "grad_norm", "entropy") if k in out}
        ran = min(stop_epoch, out["epochs_dispatched"])
        history["epochs_per_sec"] = ran / elapsed if elapsed > 0 else float("inf")
        history["train_seconds"] = elapsed
        history["num_skipped_updates"] = int(out["skipped"].sum())
        steady = steady_epochs_per_sec(out["chunk_seconds"])
        if steady is not None:
            history["epochs_per_sec_steady"] = steady
        self.history_ = history

        if track and np.isfinite(self.best_tvd_):
            bm.set_fixed_probs(out["best_probs"])
            if noisy_eval:
                # The best TVD was read on a dropout-noisy forward that cannot
                # be reproduced: restore the deterministic distribution at the
                # best parameters without the drift check.
                if verbose:
                    print(f"Restoring best parameters (noisy-eval TVD: {self.best_tvd_:.6f} "
                          f"from epoch {self.best_epoch_ + 1})")
            else:
                final_tvd = float(0.5 * (bm.probs(self.params, x_cond) - posterior_vec).abs().sum())
                if abs(final_tvd - self.best_tvd_) > 1e-6:
                    print(f"WARNING: restoration drift — expected TVD {self.best_tvd_:.6f}, "
                          f"got {final_tvd:.6f}")
                elif verbose:
                    print(f"Restored best probabilities from epoch {self.best_epoch_ + 1}: "
                          f"TVD {final_tvd:.6f}")
        if checkpoint_path:
            save_checkpoint(checkpoint_path, training_bundle(
                self.params, best_params=self.best_params_,
                best_tvd=torch.tensor(self.best_tvd_, dtype=self.dtype),
                epoch=torch.tensor(stop_epoch)))
        if verbose:
            print(f"KSD training: {ran} epochs in {elapsed:.3f}s "
                  f"({history['epochs_per_sec']:.1f} epochs/s)")
        return history

    def get_prob_dict(self, x_condition=None) -> dict:
        return self.born_machine.get_prob_dict(
            self.params, self._x_condition if x_condition is None else x_condition)


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

    def build_operator(self, x_observation_dict, temper_beta: float = 1.0) -> SteinOperator:
        """The Stein operator of the observation's posterior, or of the
        tempered target p^β: the discrete score ``s = 1 - p(flip)/p`` becomes
        ``1 - (1 - s)^β``; the zero-probability guard rows (s = 0) are fixed
        points, so the guard is kept."""
        t = self.bn.conditional_joint_table(self.latent_vars_names, x_observation_dict)
        S = score_table(t)
        if temper_beta != 1.0:
            S = 1.0 - np.power(1.0 - S, temper_beta)
        return SteinOperator(S, self.num_latent_vars, self.base_kernel_length_scale,
                             dtype=self.dtype, device=self.device)

    def train(self, x_observation_dict: Dict[str, int], num_epochs: int,
              lr_born_machine: float, verbose: bool = True, true_posterior_for_tvd=None,
              use_lr_scheduler: bool = True, gradient_clip_norm: float = 10.0,
              optimizer_type: str = "adam", adam_betas=(0.9, 0.999),
              seed: Optional[int] = None, checkpoint_path: Optional[str] = None,
              profile_dir: Optional[str] = None, chunk_epochs: Optional[int] = None,
              resume_state_path: Optional[str] = None,
              temper_betas: Optional[Sequence[float]] = None,
              keep_resume_state: bool = False) -> dict:
        """``temper_betas`` (needs ``chunk_epochs``): per-chunk inverse
        temperatures; chunk i trains against p^β[i], β past the list's end
        holding at its last value (end with 1.0 to finish on the posterior).
        One operator per distinct β, built when its first chunk starts;
        β = 1.0 is the untempered operator. The TVD is always taken against
        the untempered posterior, so the best snapshot is chosen by true
        quality.

        ``resume_state_path`` (needs ``chunk_epochs``): durable per-chunk
        resume (``run_ksd_scan``); a run resumed inside a β chunk trains
        against that chunk's target. ``checkpoint_path``: at the end,
        ``training_bundle(params, best_params, best_tvd)`` (the JAX engine's
        keys: no epoch) by ``save_checkpoint``. ``profile_dir``: a
        ``torch.profiler`` trace of the run. ``seed`` is the JAX engine's
        argument; the quantum forward draws nothing, so it changes nothing.
        ``keep_resume_state``: leave the snapshot in place at the end (the
        scale runner's phases)."""
        del seed
        if resume_state_path and not chunk_epochs:
            raise ValueError("resume_state_path requires chunk_epochs")
        if temper_betas is not None and not chunk_epochs:
            raise ValueError("temper_betas requires chunk_epochs")
        if self.num_observed_vars > 0 and set(x_observation_dict) != set(self.observed_vars_names):
            raise ValueError("Keys in x_observation_dict must match self.observed_vars_names.")
        op = self.build_operator(x_observation_dict)
        schedule = None
        if temper_betas is not None:
            betas = [float(b) for b in temper_betas]
            ops = {1.0: op}

            def schedule(chunk_index):
                beta = betas[min(chunk_index, len(betas) - 1)]
                if beta not in ops:
                    ops[beta] = self.build_operator(x_observation_dict, temper_beta=beta)
                return ops[beta]
        posterior_vec = _posterior_vec_from(true_posterior_for_tvd, self.num_latent_vars,
                                            self.dtype, self.device)
        optimizer = make_optimizer(optimizer_type, lr_born_machine, num_epochs,
                                   use_lr_scheduler, adam_betas, gradient_clip_norm)
        t0 = time.perf_counter()
        with profile_trace(profile_dir):
            out = run_ksd_scan(probs_fn=self.born_machine.probs, params0=self.params, op=op,
                               num_epochs=num_epochs, optimizer=optimizer,
                               posterior_vec=posterior_vec, chunk_epochs=chunk_epochs,
                               op_schedule=schedule, resume_state_path=resume_state_path,
                               keep_resume_state=keep_resume_state)
        elapsed = time.perf_counter() - t0

        self.params = out["params"]
        self.best_params_ = out["best_params"]
        self.best_tvd_ = out["best_tvd"]
        self.best_epoch_ = out["best_epoch"]
        history = {k: out[k].tolist() for k in ("loss_ksd", "tvd", "grad_norm")}
        # The rate over the epochs dispatched in this call: a resumed run
        # skips its finished chunks.
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
        if checkpoint_path:
            save_checkpoint(checkpoint_path, training_bundle(
                self.params, best_params=self.best_params_,
                best_tvd=torch.tensor(self.best_tvd_, dtype=self.dtype)))
        if verbose:
            print(f"Quantum KSD training: {out['epochs_dispatched']} epochs in {elapsed:.3f}s "
                  f"({history['epochs_per_sec']:.1f} epochs/s)")
        return history

    def get_prob_dict(self) -> dict:
        return self.born_machine.get_prob_dict(self.params)
