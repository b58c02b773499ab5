from .configs import QuantumKSDConfig
from .reporting import print_stability_stats
from .scale import make_scale_problem, run_scale_experiment
from .sprinkler_quantum_ksd import run_sprinkler_quantum_ksd_experiment

__all__ = ["QuantumKSDConfig", "make_scale_problem", "print_stability_stats",
           "run_scale_experiment", "run_sprinkler_quantum_ksd_experiment"]
