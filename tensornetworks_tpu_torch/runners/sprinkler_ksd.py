"""Classical KSD VI on the Sprinkler network, the reference's primary entry
point: a conditional MLP Born machine (dropout 0.1) trained by exact KSD
with an entropy term and early stopping. Counterpart of
``tensornetworks_tpu/runners/sprinkler_ksd.py``.

Run on the card: ``python -m tensornetworks_tpu_torch.runners.sprinkler_ksd``.
"""

from __future__ import annotations

from dataclasses import asdict
from typing import Optional

from ..core import calculate_tvd, get_sprinkler_network
from ..engines import KSDVariationalInference
from ..engines.ksd import not_ported
from .configs import ClassicalKSDConfig
from .reporting import print_final_report, print_stability_stats


def run_sprinkler_ksd_experiment(config: Optional[ClassicalKSDConfig] = None,
                                 verbose: bool = True, plot_path: Optional[str] = None,
                                 device="cuda"):
    """Train the configuration (shipped values by default); returns the
    history, final TVD, learned and true posteriors, the model and the
    config as a dict. ``plot_path`` is not ported yet."""
    if plot_path is not None:
        not_ported("plot_path (utils/plotting)", "A11")
    cfg = config or ClassicalKSDConfig()
    bn = get_sprinkler_network(random_cpts=False)
    latent, x_obs = cfg.latent_vars, cfg.observed
    true_posterior, p_observed = bn.get_true_posterior(latent, x_obs)
    if verbose:
        print("--- KSD Variational Inference for Sprinkler Network P(C,S,R | W=1) ---")
        print(f"True P(Observed={x_obs}) = {p_observed:.4f}")
    if p_observed < 1e-9:
        raise ValueError(f"P(Observed={x_obs}) is zero")

    model = KSDVariationalInference(
        bayesian_network=bn,
        latent_vars_names=latent,
        observed_vars_names=list(x_obs.keys()),
        born_machine_config={
            "use_logits": cfg.use_logits,
            "conditioning_dim": cfg.conditioning_dim,
            "init_method": cfg.init_method,
            "hidden_dims": cfg.hidden_dims,
            "use_layer_norm": cfg.use_layer_norm,
        },
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
        entropy_weight=cfg.entropy_weight,
        patience=cfg.patience,
    )
    learned = model.get_prob_dict()
    final_tvd = calculate_tvd(true_posterior, learned)
    if verbose:
        print_final_report(latent, x_obs, true_posterior, learned, final_tvd)
        print_stability_stats(history)
    return {"history": history, "final_tvd": final_tvd, "learned": learned,
            "true_posterior": true_posterior, "model": model, "config": asdict(cfg)}


if __name__ == "__main__":
    run_sprinkler_ksd_experiment()
