from .advi import AdversarialVariationalInference
from .common import cosine_lr_schedule, global_norm, guarded_update, make_optimizer
from .ksd import KSDVariationalInference, QuantumKSDVariationalInference, run_ksd_scan

__all__ = [
    "AdversarialVariationalInference",
    "KSDVariationalInference",
    "QuantumKSDVariationalInference",
    "cosine_lr_schedule",
    "global_norm",
    "guarded_update",
    "make_optimizer",
    "run_ksd_scan",
]
