"""Large-n runs: a random chain network of n+1 variables with an n-qubit
Born machine, trained by exact KSD or adversarially. Counterpart of
``make_scale_problem`` and the ``objective="ksd"`` and ``"adversarial"``
branches of ``run_scale_experiment`` in
``tensornetworks_tpu/runners/scale.py``.

At n ≥ 18 the Born machine resolves ``auto`` to the ``circuit2d_grid``
kernels and the Stein operator runs ``stein2d_apply_grid`` on its n+1
gcorr columns, up to 24 qubits; the 20-qubit hardware_efficient L=4 run is
the port's large-n path, the 20-qubit bn_structured L=8 run (the JAX
package's ``examples/structured_ansatz_20_qubits.py``) its structured one,
and the 24-qubit bn_structured L=8 run (``examples/exact_ksd_24_qubits.py``)
its widest (``chip_smoke.py`` drives all three on the card).
``ansatz="bn_structured"`` takes its entanglers from the network's latent
edges, as the JAX runner's engine does.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np

from ..core import get_random_chain_network
from ..engines import AdversarialVariationalInference, QuantumKSDVariationalInference
from ..engines.ksd import not_ported
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
                         warm_start: Optional[str] = None,
                         lr_phases=None, length_scale="auto", adv_batch_size: int = 256,
                         adv_k_classifier: int = 3, adv_lr_classifier_mult: float = 10.0,
                         device="cuda"):
    """Exact KSD (``objective="ksd"``) or adversarial training of the scale
    problem, with the JAX runner's keywords for these objectives.

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

    Not ported yet, and raising ``NotImplementedError``: the sampled-ksd
    objective, ``warm_start``, ``resume_state_path`` and ``checkpoint_path``.
    """
    if objective == "sampled-ksd":
        not_ported("objective='sampled-ksd'", "A9")
    if objective not in ("ksd", "adversarial"):
        raise ValueError(f"unknown objective {objective!r}")
    if warm_start is not None:
        not_ported("warm_start (fit_born_machine, marginals_product)", "A10")
    if resume_state_path is not None or checkpoint_path is not None:
        not_ported("resume_state_path / checkpoint_path", "A11")

    bn, latent, observed = make_scale_problem(num_qubits, seed)
    if track_tvd is None:
        track_tvd = num_qubits <= 20
    posterior = bn.posterior_vector(latent, observed) if track_tvd else None
    if objective == "adversarial":
        model, history = _train_adversarial(
            bn, latent, observed, posterior, num_qubits, layers, ansatz, backend, seed,
            lr_phases or [(num_epochs, lr)], chunk_epochs, verbose, adv_batch_size,
            adv_k_classifier, adv_lr_classifier_mult, device)
        return _report(history, model, num_qubits, objective, verbose)
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
                              gradient_clip_norm=10.0, chunk_epochs=chunk_epochs,
                              temper_betas=temper_betas)
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
    return _report(history, model, num_qubits, objective, verbose)


def _train_adversarial(bn, latent, observed, posterior, n, layers, ansatz, backend, seed,
                       phases, chunk_epochs, verbose, batch_size, k_classifier, lr_mult, device):
    edges = latent_edges(bn, latent) if ansatz == "bn_structured" else None
    qbm = QuantumBornMachine(n, ansatz_layers=layers, ansatz_type=ansatz, backend=backend,
                             init_method="small_random", device=device, edges=edges)
    model = AdversarialVariationalInference(
        bn, latent, list(observed), born_machine=qbm, seed=seed, device=device,
        classifier_config={"hidden_dims": [max(2 * n, 32), max(n, 16)]})
    best_tvd, best = np.inf, None
    for pi, (p_epochs, p_lr, *_) in enumerate(phases):
        history = model.train(observed, num_epochs=int(p_epochs), batch_size=batch_size,
                              lr_born_machine=float(p_lr), lr_classifier=lr_mult * float(p_lr),
                              k_classifier_steps=k_classifier, k_born_steps=1, verbose=verbose,
                              true_posterior_for_tvd=posterior, gradient_clip_norm=5.0,
                              baseline_decay=0.95, adam_betas=(0.5, 0.999),
                              chunk_epochs=chunk_epochs, seed=seed + 7919 * pi,
                              log_p_floor=60.0)
        # train() restores its phase-best (the next phase restarts from it);
        # keep the across-phase best.
        if posterior is not None and model.best_tvd_ < best_tvd:
            best_tvd = model.best_tvd_
            best = (model.born_params, model.classifier_params, model.classifier_stats)
        if verbose and len(phases) > 1:
            print(f"phase ({int(p_epochs)} epochs @ lr {p_lr}): "
                  f"best TVD {model.best_tvd_:.6f}")
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


def main(argv=None):
    ap = argparse.ArgumentParser(description="one run_scale_experiment on the card")
    ap.add_argument("--qubits", type=int, default=16)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--ansatz", default="hardware_efficient")
    ap.add_argument("--objective", choices=("ksd", "adversarial"), default="ksd")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=500, help="epochs between host syncs")
    args = ap.parse_args(argv)
    import torch

    out = run_scale_experiment(num_qubits=args.qubits, layers=args.layers,
                               num_epochs=args.epochs, lr=args.lr, objective=args.objective,
                               seed=args.seed, verbose=False, ansatz=args.ansatz,
                               chunk_epochs=args.chunk)
    model, hist = out["model"], out["history"]
    print(json.dumps({"device": torch.cuda.get_device_name(0), **vars(args),
                      "best_tvd": model.best_tvd_, "best_epoch": model.best_epoch_,
                      "tvd_epoch0": hist["tvd"][0], "train_seconds": hist["train_seconds"],
                      "epochs_per_sec": hist["epochs_per_sec"],
                      "epochs_per_sec_steady": hist.get("epochs_per_sec_steady")}))


if __name__ == "__main__":
    main()
