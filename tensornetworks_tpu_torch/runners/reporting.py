"""Console reporting shared by the runners: the truth-vs-learned table and
the stability statistics. Counterpart of
``tensornetworks_tpu/runners/reporting.py``."""

from __future__ import annotations

import numpy as np


def print_final_report(latent_vars, observed, true_posterior: dict, learned: dict,
                       final_tvd: float):
    """True against learned probability per assignment, with |diff|, then
    the final TVD."""
    print("\n--- Final Comparison: True vs Learned Posterior ---")
    header = (f"{'Assignment (' + ','.join(latent_vars) + ')':<24}{'True':>12}"
              f"{'Learned':>12}{'|diff|':>12}")
    print(header)
    print("-" * len(header))
    for key in sorted(true_posterior):
        t = true_posterior[key]
        q = learned.get(key, 0.0)
        print(f"{str(key):<24}{t:>12.6f}{q:>12.6f}{abs(t - q):>12.6f}")
    print("-" * len(header))
    print(f"Final TVD vs true posterior (evidence {observed}): {final_tvd:.6f}")


def print_stability_stats(history: dict, key: str = "tvd"):
    """TVD mean/std/min and early-vs-late spread over the finite entries of
    ``history[key]``, then the throughput (printed even without TVD
    tracking, where the steady rate matters most)."""
    vals = np.asarray(history.get(key, []), dtype=float)
    vals = vals[np.isfinite(vals)]
    if vals.size:
        n = vals.size
        early = vals[: n // 4] if n >= 8 else vals
        late = vals[-n // 4:] if n >= 8 else vals
        print(f"\nTVD stats: mean {vals.mean():.6f} | std {vals.std():.6f} | min {vals.min():.6f}")
        print(f"Stability: early-std {early.std():.6f} -> late-std {late.std():.6f}")
    if "epochs_per_sec" in history:
        steady = history.get("epochs_per_sec_steady")
        print(f"Throughput: {history['epochs_per_sec']:.1f} epochs/s "
              f"({history.get('train_seconds', float('nan')):.3f}s total"
              + (f"; steady {steady:.1f} epochs/s post-compile chunks"
                 if steady else "") + ")")
