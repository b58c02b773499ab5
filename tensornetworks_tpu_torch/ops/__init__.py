from .hamming import decay_factor, resolve_length_scale
from .kron import kron_matvec, kron_matvec_rows, kron_power_np
from .stein import (GcorrTables, SteinOperator, ksd_quadform, ksd_quadform_gcorr,
                    make_gcorr_tables, score_table, stein_gram_dense, stein_matvec,
                    stein_matvec_gcorr, stein_matvec_gcorr_tables)

__all__ = [
    "GcorrTables",
    "SteinOperator",
    "decay_factor",
    "ksd_quadform",
    "ksd_quadform_gcorr",
    "kron_matvec",
    "kron_matvec_rows",
    "kron_power_np",
    "make_gcorr_tables",
    "resolve_length_scale",
    "score_table",
    "stein_gram_dense",
    "stein_matvec",
    "stein_matvec_gcorr",
    "stein_matvec_gcorr_tables",
]
