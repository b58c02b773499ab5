from .ansatz import ANSATZ_TYPES, ansatz_probs, ansatz_state, num_ansatz_params
from .blocked2d import make_blocked2d_probs_fn

__all__ = [
    "ANSATZ_TYPES",
    "ansatz_probs",
    "ansatz_state",
    "make_blocked2d_probs_fn",
    "num_ansatz_params",
]
