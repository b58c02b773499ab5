from .advi import AdversarialVariationalInference
from .amortized import AmortizedKSD, train_multi_seed
from .common import cosine_lr_schedule, global_norm, guarded_update, make_optimizer
from .distill import fit_born_machine, fit_conditioned_born_machine, marginals_product
from .ksd import KSDVariationalInference, QuantumKSDVariationalInference, run_ksd_scan
from .sampled import SampledKSDVariationalInference

__all__ = [
    "AdversarialVariationalInference",
    "AmortizedKSD",
    "KSDVariationalInference",
    "QuantumKSDVariationalInference",
    "SampledKSDVariationalInference",
    "cosine_lr_schedule",
    "fit_born_machine",
    "fit_conditioned_born_machine",
    "global_norm",
    "guarded_update",
    "make_optimizer",
    "marginals_product",
    "run_ksd_scan",
    "train_multi_seed",
]
