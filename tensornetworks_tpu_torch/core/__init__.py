from .bayes_net import BayesianNetwork, get_random_chain_network, get_sprinkler_network
from .bits import (all_bitstrings, bits_to_index, flip_index, generate_all_binary_outcomes,
                   get_binary_key, get_outcome_tuple, popcount, torch_bits_to_index,
                   torch_index_to_bits)
from .factors import LOG_FLOOR, compile_factors, make_latent_log_joint_fn, make_log_joint_fn
from .metrics import calculate_tvd, entropy, kl_divergence, tvd

__all__ = [
    "BayesianNetwork",
    "LOG_FLOOR",
    "all_bitstrings",
    "bits_to_index",
    "calculate_tvd",
    "compile_factors",
    "entropy",
    "flip_index",
    "generate_all_binary_outcomes",
    "get_binary_key",
    "get_outcome_tuple",
    "get_random_chain_network",
    "get_sprinkler_network",
    "kl_divergence",
    "make_latent_log_joint_fn",
    "make_log_joint_fn",
    "popcount",
    "torch_bits_to_index",
    "torch_index_to_bits",
    "tvd",
]
