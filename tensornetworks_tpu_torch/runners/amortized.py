"""Amortized inference: one conditional Born machine trained over every
observation of the scale problem's evidence variable at once.

Counterpart of ``tensornetworks_tpu/runners/amortized.py``: the random
chain network of n+1 variables (``make_scale_problem``), its one observed
variable, the observations {0, 1}, and ``AmortizedKSD`` with a conditional
MLP (``quantum=False``) or a conditioned ``QuantumBornMachine``
(``conditioning_dim`` = 1; ``reupload``, ``learned_embedding`` and
``embed_per_layer`` switch its ``cond_*`` options), on the circuit kernels
up to 24 qubits.
"""

from __future__ import annotations

import numpy as np

from ..engines.amortized import AmortizedKSD
from ..models import QuantumBornMachine
from ..sim.structured import latent_edges
from .scale import make_scale_problem


def run_amortized_experiment(num_qubits: int = 4, num_epochs: int = 1500, lr: float = 3e-3,
                             layers: int = 4, quantum: bool = False,
                             ansatz: str = "hardware_efficient", entropy_weight: float = 1e-3,
                             seed: int = 0, verbose: bool = True, mesh=None,
                             reupload: bool = False, length_scale="auto", chunk_epochs=None,
                             lr_phases=None, learned_embedding: bool = False,
                             embed_per_layer: bool = False, device="cuda"):
    """Returns ``{"history", "model", "per_obs_tvd"}``: the TVD of the
    restored model to each observation's exact posterior, by its value."""
    bn, latent, observed = make_scale_problem(num_qubits, seed)
    obs_var = list(observed)[0]
    observations = [{obs_var: 0}, {obs_var: 1}]
    if quantum:
        edges = latent_edges(bn, latent) if ansatz == "bn_structured" else None
        qbm = QuantumBornMachine(num_qubits, ansatz_layers=layers, ansatz_type=ansatz,
                                 edges=edges, device=device, conditioning_dim=1,
                                 cond_reupload=reupload,
                                 cond_learned_embedding=learned_embedding,
                                 cond_embed_per_layer=embed_per_layer)
        model = AmortizedKSD(bn, latent, [obs_var], born_machine=qbm, seed=seed,
                             base_kernel_length_scale=length_scale)
    else:
        model = AmortizedKSD(bn, latent, [obs_var],
                             born_machine_config={"use_logits": True, "dropout_rate": 0.0},
                             seed=seed, base_kernel_length_scale=length_scale, device=device)
    history = model.train(observations, num_epochs=num_epochs, lr=lr,
                          entropy_weight=entropy_weight, verbose=verbose, seed=seed, mesh=mesh,
                          chunk_epochs=chunk_epochs, lr_phases=lr_phases)
    per_obs_tvd = {}
    for obs in observations:
        post = bn.posterior_vector(latent, obs)
        q = model.posterior_for(obs).cpu().numpy()
        per_obs_tvd[obs[obs_var]] = float(0.5 * np.abs(q - post).sum())
    if verbose:
        kind = "quantum" if quantum else "classical"
        print(f"amortized {kind} KSD at {num_qubits}q ({ansatz if quantum else 'MLP'}): "
              + ", ".join(f"TVD[{obs_var}={k}]={v:.4f}" for k, v in sorted(per_obs_tvd.items())))
    return {"history": history, "model": model, "per_obs_tvd": per_obs_tvd}
