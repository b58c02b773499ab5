from .advi import AdversarialVariationalInference
from .common import cosine_lr_schedule, global_norm, guarded_update, make_optimizer
from .ksd import KSDVariationalInference, QuantumKSDVariationalInference, run_ksd_scan
from .sampled import SampledKSDVariationalInference

__all__ = [
    "AdversarialVariationalInference",
    "KSDVariationalInference",
    "QuantumKSDVariationalInference",
    "SampledKSDVariationalInference",
    "cosine_lr_schedule",
    "global_norm",
    "guarded_update",
    "make_optimizer",
    "run_ksd_scan",
]
