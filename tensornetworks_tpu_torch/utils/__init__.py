from .plotting import plot_posterior_comparison, plot_stability_analysis, plot_training_results

__all__ = ["plot_posterior_comparison", "plot_stability_analysis", "plot_training_results"]
