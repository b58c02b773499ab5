"""Training-curve plotting: the history dicts the engines return, drawn and
saved to a file. Counterpart of ``tensornetworks_tpu/utils/plotting.py``.
matplotlib is imported inside each function, so nothing else in the package
needs it."""

from __future__ import annotations

from typing import Optional

import numpy as np


def plot_training_results(results_dict: dict, title: str = "Training Results",
                          save_path: Optional[str] = None, show: bool = False):
    """Stacked per-metric line plots, one panel per history key."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    metrics = {k: v for k, v in results_dict.items()
               if isinstance(v, (list, np.ndarray)) and np.ndim(v) == 1 and len(v) > 1}
    if not metrics:
        print("No results to plot.")
        return None

    fig, axes = plt.subplots(len(metrics), 1, figsize=(10, len(metrics) * 3), sharex=True)
    if len(metrics) == 1:
        axes = [axes]
    for ax, (name, values) in zip(axes, metrics.items()):
        ax.plot(range(len(values)), values, label=name)
        ax.set_ylabel(name.replace("_", " ").title())
        ax.legend()
        ax.grid(True)
    axes[-1].set_xlabel("Epoch")
    fig.suptitle(title, fontsize=16)
    plt.tight_layout(rect=[0, 0, 1, 0.96])
    if save_path:
        fig.savefig(save_path, dpi=120)
        print(f"Saved plot to {save_path}")
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig


def plot_stability_analysis(history: dict, window: int = 50,
                            title: str = "Training Stability",
                            save_path: Optional[str] = None, show: bool = False):
    """TVD curve with its rolling std, and one panel per loss in the
    history."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    tvd = np.asarray(history.get("tvd", []), dtype=float)
    finite = np.isfinite(tvd)
    panels = 2 + sum(1 for k in ("loss_ksd", "loss_born_machine", "loss_classifier")
                     if k in history)
    fig, axes = plt.subplots(panels, 1, figsize=(10, panels * 3), sharex=True)
    axes = np.atleast_1d(axes)
    ax = axes[0]
    ax.plot(np.where(finite, tvd, np.nan), label="TVD")
    if finite.any():
        best = np.nanargmin(np.where(finite, tvd, np.nan))
        ax.axvline(best, color="r", linestyle="--", alpha=0.5,
                   label=f"best @ {best + 1}")
    ax.set_ylabel("TVD")
    ax.legend()
    ax.grid(True, alpha=0.3)

    ax = axes[1]
    if tvd.size >= window:
        rolling = np.array([np.nanstd(tvd[max(0, i - window):i + 1])
                            for i in range(tvd.size)])
        ax.plot(rolling, label=f"rolling std (w={window})", color="tab:orange")
    ax.set_ylabel("TVD rolling std")
    ax.legend()
    ax.grid(True, alpha=0.3)

    i = 2
    for key in ("loss_ksd", "loss_born_machine", "loss_classifier"):
        if key in history and i < panels:
            axes[i].plot(np.asarray(history[key], dtype=float), label=key)
            axes[i].set_ylabel(key.replace("_", " "))
            axes[i].legend()
            axes[i].grid(True, alpha=0.3)
            i += 1
    axes[-1].set_xlabel("Epoch")
    fig.suptitle(title, fontsize=16)
    fig.tight_layout(rect=[0, 0, 1, 0.96])
    if save_path:
        fig.savefig(save_path, dpi=120)
        print(f"Saved plot to {save_path}")
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig


def plot_posterior_comparison(true_posterior: dict, learned: dict,
                              title: str = "True vs Learned Posterior",
                              save_path: Optional[str] = None, show: bool = False):
    """Grouped bar chart of true against learned probability per outcome."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = sorted(true_posterior)
    x = np.arange(len(keys))
    t = [true_posterior[k] for k in keys]
    l = [learned.get(k, 0.0) for k in keys]
    width = 0.38
    fig, ax = plt.subplots(figsize=(max(8, len(keys) * 0.8), 5))
    ax.bar(x - width / 2, t, width, label="True", alpha=0.85)
    ax.bar(x + width / 2, l, width, label="Learned", alpha=0.85)
    ax.set_xticks(x)
    ax.set_xticklabels(["".join(map(str, k)) for k in keys],
                       rotation=45 if len(keys) > 8 else 0)
    ax.set_ylabel("Probability")
    ax.set_title(title)
    ax.legend()
    ax.grid(True, axis="y", alpha=0.3)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        print(f"Saved plot to {save_path}")
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig
