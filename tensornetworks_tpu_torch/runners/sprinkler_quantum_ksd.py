"""Quantum KSD VI on the Sprinkler network: a 3-qubit hardware-efficient
Born machine with 4 layers, trained by exact KSD. Counterpart of
``tensornetworks_tpu/runners/sprinkler_quantum_ksd.py``.

Run on the card: ``python -m tensornetworks_tpu_torch.runners.sprinkler_quantum_ksd``.
"""

from __future__ import annotations

from dataclasses import asdict
from typing import Optional

from ..core import calculate_tvd, get_sprinkler_network
from ..engines import QuantumKSDVariationalInference
from ..utils import plot_training_results
from .configs import QuantumKSDConfig


def run_sprinkler_quantum_ksd_experiment(config: Optional[QuantumKSDConfig] = None,
                                         verbose: bool = True, plot_path: Optional[str] = None,
                                         device="cuda"):
    """Train the configuration (shipped values by default); returns the
    history, final TVD, learned and true posteriors, the model and the
    config as a dict; ``plot_path`` saves the training curves there."""
    cfg = config or QuantumKSDConfig()
    bn = get_sprinkler_network(random_cpts=False)
    latent, x_obs = cfg.latent_vars, cfg.observed
    true_posterior, p_observed = bn.get_true_posterior(latent, x_obs)
    if verbose:
        print("--- Quantum KSD VI for Sprinkler Network P(C,S,R | W=1) ---")
        print(f"True P(Observed={x_obs}) = {p_observed:.4f}")
    if p_observed < 1e-9:
        raise ValueError(f"P(Observed={x_obs}) is zero")

    model = QuantumKSDVariationalInference(
        bayesian_network=bn,
        latent_vars_names=latent,
        observed_vars_names=list(x_obs.keys()),
        qbm_num_latent_vars=len(latent),
        qbm_ansatz_layers=cfg.ansatz_layers,
        qbm_ansatz_type=cfg.ansatz_type,
        qbm_init_method=cfg.init_method,
        base_kernel_length_scale=cfg.base_kernel_length_scale,
        seed=cfg.seed,
        device=device,
    )
    history = model.train(
        x_observation_dict=x_obs,
        num_epochs=cfg.num_epochs,
        lr_born_machine=cfg.lr,
        verbose=verbose,
        true_posterior_for_tvd=true_posterior,
        use_lr_scheduler=cfg.use_lr_scheduler,
        gradient_clip_norm=cfg.gradient_clip_norm,
        optimizer_type=cfg.optimizer_type,
        adam_betas=cfg.adam_betas,
    )
    learned = model.get_prob_dict()
    final_tvd = calculate_tvd(true_posterior, learned)
    if verbose:
        print(f"{'Assignment (' + ','.join(latent) + ')':<24}{'True':>12}{'Learned':>12}")
        for key in sorted(true_posterior):
            print(f"{str(key):<24}{true_posterior[key]:>12.6f}{learned.get(key, 0.0):>12.6f}")
        print(f"Final TVD vs true posterior (evidence {x_obs}): {final_tvd:.6f}")
    if plot_path:
        plot_training_results(history, "Quantum KSD VI", save_path=plot_path)
    return {"history": history, "final_tvd": final_tvd, "learned": learned,
            "true_posterior": true_posterior, "model": model, "config": asdict(cfg)}


if __name__ == "__main__":
    run_sprinkler_quantum_ksd_experiment()
