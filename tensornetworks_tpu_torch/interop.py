"""Carry state across from the JAX package: the same θ in both.

The JAX and torch random generators differ, so a test that holds the two
engines against each other draws θ once (on the JAX side, or with numpy)
and hands the same numbers to both. Nothing here imports JAX: θ arrives as a
numpy array.
"""

from __future__ import annotations

import numpy as np
import torch

from .engines.ksd import QuantumKSDVariationalInference


def params_from_jax(theta: np.ndarray, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """The flat ``3·L·n`` (or ``2·L·n``) parameter vector of the JAX Born
    machine as a torch tensor; the layout (layer, qubit, angle) is shared."""
    theta = np.asarray(theta)
    if theta.ndim != 1:
        raise ValueError(f"expected a flat parameter vector, got shape {theta.shape}")
    return torch.as_tensor(theta, dtype=dtype, device=device).clone()


def quantum_engine_with_params(theta: np.ndarray, bayesian_network, latent_vars_names,
                               observed_vars_names, **engine_kwargs
                               ) -> QuantumKSDVariationalInference:
    """The port's quantum KSD engine on ``bayesian_network``, started from θ."""
    engine = QuantumKSDVariationalInference(bayesian_network, latent_vars_names,
                                            observed_vars_names,
                                            qbm_num_latent_vars=len(latent_vars_names),
                                            **engine_kwargs)
    if theta.shape != (engine.born_machine.num_params,):
        raise ValueError(f"θ has shape {theta.shape}, the Born machine takes "
                         f"({engine.born_machine.num_params},)")
    engine.params = params_from_jax(theta, device=engine.device, dtype=engine.dtype)
    return engine
