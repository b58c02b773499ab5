"""Adversarial VI on the Sprinkler network: a conditional classical Born
machine against an MLP discriminator, REINFORCE with an EMA baseline.
Counterpart of ``tensornetworks_tpu/runners/sprinkler_adversarial.py``.

Run on the card: ``python -m tensornetworks_tpu_torch.runners.sprinkler_adversarial``.
"""

from __future__ import annotations

from dataclasses import asdict
from typing import Optional

from ..core import calculate_tvd, get_sprinkler_network
from ..engines import AdversarialVariationalInference
from .configs import AdversarialConfig
from ..utils import plot_training_results
from .reporting import print_final_report, print_stability_stats


def run_sprinkler_experiment(config: Optional[AdversarialConfig] = None, verbose: bool = True,
                             plot_path: Optional[str] = None, device="cuda"):
    """Train the configuration (shipped values by default); returns the
    history, final TVD, learned and true posteriors, the model and the
    config as a dict; ``plot_path`` saves the training curves there."""
    cfg = config or AdversarialConfig()
    bn = get_sprinkler_network(random_cpts=False)
    latent, x_obs = cfg.latent_vars, cfg.observed
    true_posterior, p_observed = bn.get_true_posterior(latent, x_obs)
    if verbose:
        print("--- Adversarial VI for Sprinkler Network P(C,S,R | W=1) ---")
        print(f"True P(Observed={x_obs}) = {p_observed:.4f}")
    if p_observed < 1e-9:
        raise ValueError(f"P(Observed={x_obs}) is zero")

    model = AdversarialVariationalInference(
        bayesian_network=bn,
        latent_vars_names=latent,
        observed_vars_names=list(x_obs.keys()),
        born_machine_config={
            "use_logits": cfg.use_logits,
            "conditioning_dim": cfg.conditioning_dim,
            "init_method": cfg.init_method,
        },
        classifier_config={
            "hidden_dims": cfg.classifier_hidden_dims,
            "use_batch_norm": cfg.use_batch_norm,
        },
        seed=cfg.seed,
        device=device,
    )
    history = model.train(
        x_observation_dict=x_obs,
        num_epochs=cfg.num_epochs,
        batch_size=cfg.batch_size,
        lr_born_machine=cfg.lr_born,
        lr_classifier=cfg.lr_classifier,
        k_classifier_steps=cfg.k_classifier_steps,
        k_born_steps=cfg.k_born_steps,
        verbose=verbose,
        true_posterior_for_tvd=true_posterior,
        use_lr_scheduler=cfg.use_lr_scheduler,
        gradient_clip_norm=cfg.gradient_clip_norm,
        baseline_decay=cfg.baseline_decay,
        optimizer_type=cfg.optimizer_type,
        adam_betas=cfg.adam_betas,
    )
    learned = model.get_prob_dict()
    final_tvd = calculate_tvd(true_posterior, learned)
    if verbose:
        print_final_report(latent, x_obs, true_posterior, learned, final_tvd)
        print_stability_stats(history)
    if plot_path:
        plot_training_results(history, "Adversarial VI", save_path=plot_path)
    return {"history": history, "final_tvd": final_tvd, "learned": learned,
            "true_posterior": true_posterior, "model": model, "config": asdict(cfg)}


if __name__ == "__main__":
    run_sprinkler_experiment()
