"""Large-n runs: a random chain network of n+1 variables with an n-qubit
Born machine, trained by exact KSD, by sampled KSD or adversarially.
Counterpart of ``make_scale_problem``, the ``objective="ksd"``,
``"sampled-ksd"`` and ``"adversarial"`` branches of
``run_scale_experiment`` and ``run_sampling_throughput`` in
``tensornetworks_tpu/runners/scale.py``.

At n ≥ 18 the Born machine resolves ``auto`` to the ``circuit2d_grid``
kernels and the Stein operator runs ``stein2d_apply_grid`` on its n+1
gcorr columns, up to 24 qubits; the 20-qubit hardware_efficient L=4 run is
the port's large-n path, the 20-qubit bn_structured L=8 run (the JAX
package's ``examples/structured_ansatz_20_qubits.py``) its structured one,
and the 24-qubit bn_structured L=8 run (``examples/exact_ksd_24_qubits.py``)
its widest (``chip_smoke.py`` drives all three on the card).
``ansatz="bn_structured"`` takes its entanglers from the network's latent
edges, as the JAX runner's engine does. The sampled objective needs no 2^n
Stein structure; past 24 qubits an FP32 Born machine under the kernel
precision ``highest`` runs the grid kernels' gate path to 30 qubits, and
any other the blocked executor (the adjoint backward from 26), which
launches no kernel.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from ..core import get_random_chain_network
from ..engines import (AdversarialVariationalInference, QuantumKSDVariationalInference,
                       SampledKSDVariationalInference, fit_born_machine, marginals_product)
from ..models import QuantumBornMachine
from ..ops.hamming import resolve_length_scale
from ..sim.structured import latent_edges
from .reporting import print_stability_stats


def make_scale_problem(num_qubits: int, seed: int = 0):
    """num_qubits latent vars + 1 observed var, random CPT DAG."""
    bn = get_random_chain_network(num_qubits + 1, seed=seed)
    latent = [f"V{i}" for i in range(num_qubits)]
    observed = {f"V{num_qubits}": 1}
    return bn, latent, observed


def run_scale_experiment(num_qubits: int = 8, layers: int = 4, num_epochs: int = 200,
                         lr: float = 5e-3, objective: str = "ksd", seed: int = 0,
                         verbose: bool = True, track_tvd: Optional[bool] = None,
                         ansatz: str = "hardware_efficient",
                         chunk_epochs: Optional[int] = None,
                         resume_state_path: Optional[str] = None,
                         temper_betas=None, backend: str = "auto",
                         checkpoint_path: Optional[str] = None,
                         warm_start: Optional[str] = None, warm_start_epochs: int = 2000,
                         lr_phases=None, length_scale="auto", adv_batch_size: int = 256,
                         adv_k_classifier: int = 3, adv_lr_classifier_mult: float = 10.0,
                         num_samples: int = 1024, grad_method: str = "auto",
                         grad_baseline: str = "loo", device="cuda"):
    """Exact KSD (``objective="ksd"``), sampled KSD (``"sampled-ksd"``) or
    adversarial training of the scale problem, with the JAX runner's
    keywords for these objectives.

    ``lr_phases``: list of ``(epochs, lr)`` or ``(epochs, lr, length_scale)``
    — LR-annealed warm restarts. Each phase restarts the cosine schedule from
    the previous phase's best-TVD snapshot (``train`` restores it) at its own
    peak LR, optionally at its own kernel length scale; overrides
    ``num_epochs``/``lr``. The returned history is the final phase's; the
    model is left at the across-phase best parameters.

    ``length_scale``: the Hamming kernel bandwidth, a float or ``"auto"``
    (1/n up to 17 variables, 2/n from 18). ``track_tvd`` defaults to
    n ≤ 20 (the exact posterior is a dense 2^n vector).

    The adversarial objective trains a quantum Born machine against the
    discriminator ``[max(2n, 32), max(n, 16)]``: batch ``adv_batch_size``,
    ``adv_k_classifier`` discriminator steps per REINFORCE step, the
    discriminator's lr ``adv_lr_classifier_mult`` times the Born machine's,
    clip 5.0, baseline decay 0.95, betas (0.5, 0.999) and the finite
    ``log p(x|z)`` floor of 60 (the reference's ±inf edges freeze REINFORCE
    from n ≈ 16). Each phase of ``lr_phases`` (their length scales
    ignored) restarts from the previous phase's best with the seed
    ``seed + 7919·phase``; the across-phase best is restored at the end.

    ``temper_betas`` (ksd objective, needs ``chunk_epochs``): per-chunk
    inverse temperatures of the target p^β, passed to
    ``QuantumKSDVariationalInference.train``.

    The sampled objective trains ``SampledKSDVariationalInference`` with
    ``num_samples`` shots per epoch, ``grad_method`` (the Born machine's
    ``qbm_grad_method``) and ``grad_baseline``, for ``num_epochs`` at
    ``lr``, clip 10, in chunks of ``chunk_epochs`` (default 50 from 20
    qubits). Like the JAX runner it runs hardware_efficient; a different
    ``ansatz`` raises, where the JAX runner ignores it.

    ``warm_start="marginals"`` (ksd objective): before KSD training, fit
    the Born machine toward the product of the exact posterior's marginals
    (``engines.marginals_product``, ``fit_born_machine`` at lr 0.05 for
    ``warm_start_epochs``, in chunks of ``chunk_epochs``) and start from the
    fitted parameters; the fit's history is returned under
    ``"warm_start"``.

    ``resume_state_path`` (ksd and adversarial objectives, needs
    ``chunk_epochs``): durable per-chunk resume, passed to each phase's
    ``train``. With several ``lr_phases`` phase i resumes from its own
    ``f"{path}.phase{i}"`` (see ``phase_resume_paths``), and every phase's
    snapshot is kept until the last phase ends, so a rerun after a kill
    replays the finished phases from their snapshots without training and
    resumes the interrupted one. ``checkpoint_path`` (ksd and adversarial):
    each phase's ``train`` writes its checkpoint there at its end, so the
    last phase's stays. The sampled objective has neither hook and raises
    for them (the JAX runner ignores them).
    """
    if objective not in ("ksd", "adversarial", "sampled-ksd"):
        raise ValueError(f"unknown objective {objective!r}")
    if objective == "sampled-ksd" and ansatz != "hardware_efficient":
        raise ValueError("objective='sampled-ksd' runs the hardware_efficient ansatz, "
                         f"got ansatz={ansatz!r}")
    if warm_start is not None and warm_start != "marginals":
        raise ValueError(f"unknown warm_start {warm_start!r}; expected 'marginals'")
    if warm_start is not None and objective != "ksd":
        raise ValueError(f"warm_start applies to the ksd objective, not {objective!r}")
    if objective == "sampled-ksd" and (resume_state_path or checkpoint_path):
        raise ValueError("the sampled engine has no resume or checkpoint hook "
                         "(resume_state_path, checkpoint_path)")

    bn, latent, observed = make_scale_problem(num_qubits, seed)
    if track_tvd is None:
        track_tvd = num_qubits <= 20
    posterior = bn.posterior_vector(latent, observed) if track_tvd else None
    if objective == "sampled-ksd":
        model = SampledKSDVariationalInference(
            bn, latent, list(observed), qbm_ansatz_layers=layers,
            qbm_ansatz_type="hardware_efficient", qbm_init_method="small_random",
            num_samples=num_samples, seed=seed, qbm_grad_method=grad_method,
            grad_baseline=grad_baseline, base_kernel_length_scale=length_scale, device=device)
        history = model.train(observed, num_epochs=num_epochs, lr_born_machine=lr,
                              verbose=verbose, true_posterior_for_tvd=posterior,
                              gradient_clip_norm=10.0,
                              chunk_epochs=(chunk_epochs if chunk_epochs
                                            else (50 if num_qubits >= 20 else None)))
        return _report(history, model, num_qubits, objective, verbose)
    if objective == "adversarial":
        model, history = _train_adversarial(
            bn, latent, observed, posterior, num_qubits, layers, ansatz, backend, seed,
            lr_phases or [(num_epochs, lr)], chunk_epochs, verbose, adv_batch_size,
            adv_k_classifier, adv_lr_classifier_mult, device, resume_state_path,
            checkpoint_path)
        return _report(history, model, num_qubits, objective, verbose)
    model = QuantumKSDVariationalInference(
        bn, latent, list(observed), qbm_num_latent_vars=num_qubits,
        qbm_ansatz_layers=layers, qbm_ansatz_type=ansatz, qbm_init_method="small_random",
        seed=seed, qbm_backend=backend, base_kernel_length_scale=length_scale, device=device)
    warm = None
    if warm_start is not None:
        target = posterior if posterior is not None else bn.posterior_vector(latent, observed)
        t0 = time.perf_counter()
        model.params, warm = fit_born_machine(
            model.born_machine, marginals_product(target, num_qubits),
            num_epochs=warm_start_epochs, lr=0.05, chunk_epochs=chunk_epochs, seed=seed)
        if verbose:
            print(f"warm start: TVD(model, marginals surrogate) = {warm['best_tvd']:.4f} "
                  f"in {time.perf_counter() - t0:.0f}s")
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
                              temper_betas=temper_betas, resume_state_path=resume_path,
                              checkpoint_path=checkpoint_path,
                              keep_resume_state=len(phases) > 1)
        # Each train() restores its own phase-best into model.params (the next
        # phase restarts from it); a later phase can end worse than an earlier
        # one, so keep the across-phase best.
        if posterior is not None and model.best_tvd_ < best_tvd:
            best_tvd, best_params = model.best_tvd_, model.best_params_
        if verbose and len(phases) > 1:
            print(f"phase ({int(p_epochs)} epochs @ lr {p_lr}): "
                  f"best TVD {model.best_tvd_:.6f}")
    remove_phase_snapshots(resume_paths)
    if best_params is not None:
        model.params = best_params
        model.best_params_ = best_params
        model.best_tvd_ = best_tvd
    out = _report(history, model, num_qubits, objective, verbose)
    if warm is not None:
        out["warm_start"] = warm
    return out


def phase_resume_paths(path: Optional[str], num_phases: int) -> list:
    """The resume snapshot of each ``lr_phases`` phase: the path itself for
    one phase, ``f"{path}.phase{i}"`` for phase i of several. The JAX runner
    passes one path to every phase (``runners/scale.py:134`` and ``:190``
    there), so its phase 2 replays phase 1's snapshot or raises a
    fingerprint mismatch (ADVICE.md); here each phase has its own."""
    if path is None or num_phases == 1:
        return [path] * num_phases
    return [f"{path}.phase{i}" for i in range(num_phases)]


def remove_phase_snapshots(paths) -> None:
    """After the last phase: the phases' snapshots, kept until then so that
    a rerun replays the finished phases, are removed."""
    if len(paths) > 1:
        for p in paths:
            if p is not None and os.path.exists(p):
                os.remove(p)


def _train_adversarial(bn, latent, observed, posterior, n, layers, ansatz, backend, seed,
                       phases, chunk_epochs, verbose, batch_size, k_classifier, lr_mult, device,
                       resume_state_path, checkpoint_path):
    edges = latent_edges(bn, latent) if ansatz == "bn_structured" else None
    qbm = QuantumBornMachine(n, ansatz_layers=layers, ansatz_type=ansatz, backend=backend,
                             init_method="small_random", device=device, edges=edges)
    model = AdversarialVariationalInference(
        bn, latent, list(observed), born_machine=qbm, seed=seed, device=device,
        classifier_config={"hidden_dims": [max(2 * n, 32), max(n, 16)]})
    resume_paths = phase_resume_paths(resume_state_path, len(phases))
    best_tvd, best = np.inf, None
    for pi, (p_epochs, p_lr, *_) in enumerate(phases):
        history = model.train(observed, num_epochs=int(p_epochs), batch_size=batch_size,
                              lr_born_machine=float(p_lr), lr_classifier=lr_mult * float(p_lr),
                              k_classifier_steps=k_classifier, k_born_steps=1, verbose=verbose,
                              true_posterior_for_tvd=posterior, gradient_clip_norm=5.0,
                              baseline_decay=0.95, adam_betas=(0.5, 0.999),
                              chunk_epochs=chunk_epochs, seed=seed + 7919 * pi,
                              log_p_floor=60.0, resume_state_path=resume_paths[pi],
                              checkpoint_path=checkpoint_path,
                              keep_resume_state=len(phases) > 1)
        # train() restores its phase-best (the next phase restarts from it);
        # keep the across-phase best.
        if posterior is not None and model.best_tvd_ < best_tvd:
            best_tvd = model.best_tvd_
            best = (model.born_params, model.classifier_params, model.classifier_stats)
        if verbose and len(phases) > 1:
            print(f"phase ({int(p_epochs)} epochs @ lr {p_lr}): "
                  f"best TVD {model.best_tvd_:.6f}")
    remove_phase_snapshots(resume_paths)
    if best is not None:
        model.born_params, model.classifier_params, model.classifier_stats = best
        model.best_tvd_ = best_tvd
    return model, history


def _report(history, model, num_qubits, objective, verbose):
    if verbose:
        tvds = np.asarray(history["tvd"], dtype=float)
        finite = tvds[np.isfinite(tvds)]
        if finite.size:
            print(f"{num_qubits}-qubit {objective}: final TVD {finite[-1]:.6f}, "
                  f"best {finite.min():.6f}")
        print_stability_stats(history)
    return {"history": history, "model": model, "num_qubits": num_qubits,
            "objective": objective}


def run_sampling_throughput(num_qubits: int = 20, layers: int = 2, num_samples: int = 1 << 16,
                            verbose: bool = True, backend: str = "auto", device="cuda"):
    """Born-machine sampling throughput (the JAX package's BASELINE config
    5): the hardware_efficient forward and ``num_samples`` inverse-CDF
    shots, timed over 5 draws after a warm-up, each ending in a sync."""
    import torch

    qbm = QuantumBornMachine(num_qubits, ansatz_layers=layers, ansatz_type="hardware_efficient",
                             backend=backend, device=device)
    params = qbm.init(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=qbm.device).manual_seed(1)

    def draw():
        with torch.no_grad():
            s = qbm.sample(gen, params, num_samples)
        float(s[0, 0])  # the value fetch waits for the device
        return s

    draw()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        draw()
    dt = (time.perf_counter() - t0) / reps
    rate = num_samples / dt
    if verbose:
        print(f"{num_qubits}-qubit sampling: {rate:,.0f} samples/s "
              f"({num_samples} samples in {dt * 1e3:.1f} ms incl. statevector forward)")
    return {"samples_per_sec": rate, "num_qubits": num_qubits}

