"""Carry state across from the JAX package: the same parameters in both.

The JAX and torch random generators differ, so a test that holds the two
engines against each other draws the parameters once (on the JAX side, or
with numpy) and hands the same numbers to both. Nothing here imports JAX:
parameters arrive as numpy arrays, or as nested dicts of them (a Flax
pytree passed through ``jax.tree.map(np.asarray, ...)``), and leave as the
port's flat vectors.
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


def flat_from_flax(tree: dict, layout, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """A Flax parameter (or batch-stats) pytree as the flat vector of
    ``layout`` (``models.born_classical.mlp_layout``, a Born machine's or a
    classifier's ``layout``/``stats_layout``). A Flax ``Dense`` kernel is
    (in, out) and the port's weight (out, in), so it is transposed; the
    table's layout entry reads ``tree["table"]``."""
    pieces = []
    for module, leaf, shape in layout:
        if leaf is None:
            arr = np.asarray(tree[module])
        elif leaf == "weight":
            arr = np.asarray(tree[module]["kernel"]).T
        else:
            arr = np.asarray(tree[module][leaf])
        if arr.shape != tuple(shape):
            raise ValueError(f"{module}.{leaf}: shape {arr.shape}, the layout takes {shape}")
        pieces.append(arr.reshape(-1))
    flat = np.concatenate(pieces) if pieces else np.zeros(0)
    return torch.as_tensor(flat, dtype=dtype, device=device).clone()


def classifier_from_flax(variables: dict, classifier, device="cuda", dtype=torch.float32):
    """The discriminator's Flax ``variables`` (``params`` and, with
    BatchNorm, ``batch_stats``) as the port's (params, stats) pair."""
    params = flat_from_flax(variables["params"], classifier.layout, device, dtype)
    stats = (flat_from_flax(variables["batch_stats"], classifier.stats_layout, device, dtype)
             if classifier.use_batch_norm else None)
    return params, stats


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
