from .hamming import decay_factor, resolve_length_scale
from .kron import kron_matvec, kron_power_np
from .stein import SteinOperator, ksd_quadform, score_table, stein_gram_dense, stein_matvec

__all__ = [
    "SteinOperator",
    "decay_factor",
    "ksd_quadform",
    "kron_matvec",
    "kron_power_np",
    "resolve_length_scale",
    "score_table",
    "stein_gram_dense",
    "stein_matvec",
]
