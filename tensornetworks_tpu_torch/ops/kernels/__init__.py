"""The port's hand-written CUDA kernels (``csrc/``) with their plain torch
versions, launch counters and build helpers."""

from ._lib import LAUNCHES, build_all, reset_launches
from .circuit2d import Circuit2dFunction, CircuitPlan, make_circuit2d_probs_fn
from .stein2d import stein2d_apply, stein2d_apply_plain

__all__ = [
    "Circuit2dFunction",
    "CircuitPlan",
    "LAUNCHES",
    "build_all",
    "make_circuit2d_probs_fn",
    "reset_launches",
    "stein2d_apply",
    "stein2d_apply_plain",
]
