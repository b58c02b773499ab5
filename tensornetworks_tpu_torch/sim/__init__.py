from .adjoint import make_adjoint_probs_fn, primitive_ansatz_program
from .ansatz import ANSATZ_TYPES, ansatz_probs, ansatz_state, num_ansatz_params
from .blocked import make_block_matrices_fn, make_blocked_probs_fn, make_blocked_state_fn
from .blocked2d import make_blocked2d_probs_fn
from .blocked_adjoint import make_blocked_adjoint_probs_fn
from .sampling import (CDF_SAMPLING_MIN_SIZE, draw_uniforms, gather_2d, inverse_cdf_sampler,
                       parameter_shift_jacobian, sample_bits, sample_indices, sample_indices_2d)
from .structured import latent_edges, make_structured_probs_fn

__all__ = [
    "ANSATZ_TYPES",
    "CDF_SAMPLING_MIN_SIZE",
    "ansatz_probs",
    "ansatz_state",
    "draw_uniforms",
    "gather_2d",
    "inverse_cdf_sampler",
    "latent_edges",
    "make_adjoint_probs_fn",
    "make_block_matrices_fn",
    "make_blocked2d_probs_fn",
    "make_blocked_adjoint_probs_fn",
    "make_blocked_probs_fn",
    "make_blocked_state_fn",
    "make_structured_probs_fn",
    "num_ansatz_params",
    "parameter_shift_jacobian",
    "primitive_ansatz_program",
    "sample_bits",
    "sample_indices",
    "sample_indices_2d",
]
