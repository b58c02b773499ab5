from .common import cosine_lr_schedule, global_norm, guarded_update, make_optimizer
from .ksd import QuantumKSDVariationalInference, run_ksd_scan

__all__ = [
    "QuantumKSDVariationalInference",
    "cosine_lr_schedule",
    "global_norm",
    "guarded_update",
    "make_optimizer",
    "run_ksd_scan",
]
