from .ansatz import ANSATZ_TYPES, ansatz_probs, ansatz_state, num_ansatz_params
from .blocked2d import make_blocked2d_probs_fn
from .structured import latent_edges, make_structured_probs_fn

__all__ = [
    "ANSATZ_TYPES",
    "ansatz_probs",
    "ansatz_state",
    "latent_edges",
    "make_blocked2d_probs_fn",
    "make_structured_probs_fn",
    "num_ansatz_params",
]
