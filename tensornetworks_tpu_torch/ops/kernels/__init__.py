"""The port's hand-written CUDA kernels (``csrc/``) with their plain torch
versions, launch counters and build helpers."""

from ._lib import LAUNCHES, build_all, reset_launches
from .circuit2d import Circuit2dFunction, CircuitPlan, make_circuit2d_probs_fn
from .circuit2d_grid import Circuit2dGridFunction, GridPlan, make_circuit2d_grid_probs_fn
from .stein2d import (stein2d_apply, stein2d_apply_grid, stein2d_apply_plain,
                      stein2d_butterfly_plain, stein2d_cluster_plain)
from .stein_gcorr import gcorr_combine, gcorr_combine_plain

__all__ = [
    "Circuit2dFunction",
    "Circuit2dGridFunction",
    "CircuitPlan",
    "GridPlan",
    "LAUNCHES",
    "build_all",
    "gcorr_combine",
    "gcorr_combine_plain",
    "make_circuit2d_grid_probs_fn",
    "make_circuit2d_probs_fn",
    "reset_launches",
    "stein2d_apply",
    "stein2d_apply_grid",
    "stein2d_apply_plain",
    "stein2d_butterfly_plain",
    "stein2d_cluster_plain",
]
