"""Large-n exact KSD runs: a random chain network of n+1 variables with an
n-qubit Born machine. Counterpart of ``make_scale_problem`` and the
``objective="ksd"`` branch of ``run_scale_experiment`` in
``tensornetworks_tpu/runners/scale.py``.

At n ≥ 18 the Born machine resolves ``auto`` to the ``circuit2d_grid``
kernels and the Stein operator runs ``stein2d_apply_grid``; the 20-qubit
hardware_efficient L=4 run is the port's large-n path, and the 20-qubit
bn_structured L=8 run (the JAX package's
``examples/structured_ansatz_20_qubits.py``) its structured one
(``chip_smoke.py`` drives both on the card). ``ansatz="bn_structured"``
takes its entanglers from the network's latent edges, as the JAX runner's
engine does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import get_random_chain_network
from ..engines import QuantumKSDVariationalInference
from ..ops.hamming import resolve_length_scale
from .reporting import print_stability_stats


def make_scale_problem(num_qubits: int, seed: int = 0):
    """num_qubits latent vars + 1 observed var, random CPT DAG."""
    bn = get_random_chain_network(num_qubits + 1, seed=seed)
    latent = [f"V{i}" for i in range(num_qubits)]
    observed = {f"V{num_qubits}": 1}
    return bn, latent, observed


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to the PyTorch package yet "
                              f"(ROADMAP {item})")


def run_scale_experiment(num_qubits: int = 8, layers: int = 4, num_epochs: int = 200,
                         lr: float = 5e-3, objective: str = "ksd", seed: int = 0,
                         verbose: bool = True, track_tvd: Optional[bool] = None,
                         ansatz: str = "hardware_efficient",
                         chunk_epochs: Optional[int] = None,
                         resume_state_path: Optional[str] = None,
                         temper_betas=None, backend: str = "auto",
                         checkpoint_path: Optional[str] = None,
                         warm_start: Optional[str] = None,
                         lr_phases=None, length_scale="auto", device="cuda"):
    """Exact KSD training of the scale problem, with the JAX runner's keywords
    for this objective.

    ``lr_phases``: list of ``(epochs, lr)`` or ``(epochs, lr, length_scale)``
    — LR-annealed warm restarts. Each phase restarts the cosine schedule from
    the previous phase's best-TVD snapshot (``train`` restores it) at its own
    peak LR, optionally at its own kernel length scale; overrides
    ``num_epochs``/``lr``. The returned history is the final phase's; the
    model is left at the across-phase best parameters.

    ``length_scale``: the Hamming kernel bandwidth, a float or ``"auto"``
    (1/n up to 17 variables, 2/n from 18). ``track_tvd`` defaults to
    n ≤ 20 (the exact posterior is a dense 2^n vector).

    Not ported yet, and raising ``NotImplementedError``: the adversarial and
    sampled-ksd objectives, ``warm_start``, ``resume_state_path``,
    ``temper_betas`` and ``checkpoint_path``.
    """
    if objective == "adversarial":
        _not_ported("objective='adversarial'", "A8")
    if objective == "sampled-ksd":
        _not_ported("objective='sampled-ksd'", "A9")
    if objective != "ksd":
        raise ValueError(f"unknown objective {objective!r}")
    if warm_start is not None:
        _not_ported("warm_start (fit_born_machine, marginals_product)", "A10")
    if resume_state_path is not None or checkpoint_path is not None:
        _not_ported("resume_state_path / checkpoint_path", "A11")
    if temper_betas is not None:
        _not_ported("temper_betas", "A4")

    bn, latent, observed = make_scale_problem(num_qubits, seed)
    if track_tvd is None:
        track_tvd = num_qubits <= 20
    posterior = bn.posterior_vector(latent, observed) if track_tvd else None
    model = QuantumKSDVariationalInference(
        bn, latent, list(observed), qbm_num_latent_vars=num_qubits,
        qbm_ansatz_layers=layers, qbm_ansatz_type=ansatz, qbm_init_method="small_random",
        seed=seed, qbm_backend=backend, base_kernel_length_scale=length_scale, device=device)
    phases = list(lr_phases) if lr_phases else [(num_epochs, lr)]
    best_tvd, best_params = np.inf, None
    for phase in phases:
        if len(phase) == 3:
            p_epochs, p_lr, p_ls = phase
            model.base_kernel_length_scale = resolve_length_scale(p_ls, num_qubits)
        else:
            p_epochs, p_lr = phase
        history = model.train(observed, num_epochs=int(p_epochs), lr_born_machine=float(p_lr),
                              verbose=verbose, true_posterior_for_tvd=posterior,
                              gradient_clip_norm=10.0, chunk_epochs=chunk_epochs)
        # Each train() restores its own phase-best into model.params (the next
        # phase restarts from it); a later phase can end worse than an earlier
        # one, so keep the across-phase best.
        if posterior is not None and model.best_tvd_ < best_tvd:
            best_tvd, best_params = model.best_tvd_, model.best_params_
        if verbose and len(phases) > 1:
            print(f"phase ({int(p_epochs)} epochs @ lr {p_lr}): "
                  f"best TVD {model.best_tvd_:.6f}")
    if best_params is not None:
        model.params = best_params
        model.best_params_ = best_params
        model.best_tvd_ = best_tvd

    if verbose:
        tvds = np.asarray(history["tvd"], dtype=float)
        finite = tvds[np.isfinite(tvds)]
        if finite.size:
            print(f"{num_qubits}-qubit {objective}: final TVD {finite[-1]:.6f}, "
                  f"best {finite.min():.6f}")
        print_stability_stats(history)
    return {"history": history, "model": model, "num_qubits": num_qubits,
            "objective": objective}

