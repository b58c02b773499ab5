from .configs import QuantumKSDConfig
from .sprinkler_quantum_ksd import run_sprinkler_quantum_ksd_experiment

__all__ = ["QuantumKSDConfig", "run_sprinkler_quantum_ksd_experiment"]
