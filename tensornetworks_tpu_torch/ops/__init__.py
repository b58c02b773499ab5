from .hamming import decay_factor, resolve_length_scale
from .kron import apply_adjacent_block, kron_matvec, kron_matvec_rows, kron_power_np
from .stein import (GcorrTables, SteinOperator, ksd_quadform, ksd_quadform_gcorr,
                    make_gcorr_tables, score_table, stein_gram_dense, stein_matvec,
                    stein_matvec_gcorr, stein_matvec_gcorr_tables)
from .stein_sampled import (fit_linear_control_variate, ksd_ustat, ksd_vstat,
                            reinforce_surrogate, reinforce_surrogate_cv,
                            reinforce_surrogate_weighted, score_at_samples, stein_gram_samples)

__all__ = [
    "GcorrTables",
    "apply_adjacent_block",
    "SteinOperator",
    "decay_factor",
    "fit_linear_control_variate",
    "ksd_quadform",
    "ksd_quadform_gcorr",
    "ksd_ustat",
    "ksd_vstat",
    "kron_matvec",
    "kron_matvec_rows",
    "kron_power_np",
    "make_gcorr_tables",
    "reinforce_surrogate",
    "reinforce_surrogate_cv",
    "reinforce_surrogate_weighted",
    "resolve_length_scale",
    "score_at_samples",
    "score_table",
    "stein_gram_samples",
    "stein_gram_dense",
    "stein_matvec",
    "stein_matvec_gcorr",
    "stein_matvec_gcorr_tables",
]
