from .amortized import run_amortized_experiment
from .configs import AdversarialConfig, ClassicalKSDConfig, QuantumKSDConfig, ScaleConfig
from .reporting import print_final_report, print_stability_stats
from .scale import make_scale_problem, run_sampling_throughput, run_scale_experiment
from .sprinkler_adversarial import run_sprinkler_experiment
from .sprinkler_ksd import run_sprinkler_ksd_experiment
from .sprinkler_quantum_ksd import run_sprinkler_quantum_ksd_experiment

__all__ = ["AdversarialConfig", "ClassicalKSDConfig", "QuantumKSDConfig", "ScaleConfig",
           "make_scale_problem",
           "print_final_report", "print_stability_stats", "run_amortized_experiment",
           "run_distributed_scale_experiment",
           "run_sampling_throughput",
           "run_scale_experiment",
           "run_sprinkler_experiment", "run_sprinkler_ksd_experiment",
           "run_sprinkler_quantum_ksd_experiment"]


def __getattr__(name):
    # The distributed runner loads torch.distributed's mesh only when named
    # (see engines/__init__.py).
    if name == "run_distributed_scale_experiment":
        from .scale_distributed import run_distributed_scale_experiment

        return run_distributed_scale_experiment
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
