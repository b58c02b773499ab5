"""Quantum Born machine on the port's statevector simulator.

Counterpart of ``tensornetworks_tpu/models/born_quantum.py``, unconditioned,
for the reference ansätze (``hardware_efficient``, ``all_to_all``,
``basic``) and the DAG-structured ``bn_structured``, whose entanglers follow
``edges`` (required; see ``sim.structured.latent_edges``). ``probs(params)``
is the analytic |ψ(θ)|² over all 2^n outcomes; gradients flow through torch
autograd. The model exposes probabilities only, as the JAX model does for
``bn_structured``.

Backends (all give the same distribution):
- ``circuit2d``: the hand-written CUDA circuit kernels (forward and adjoint
  backward) of ``ops/kernels/circuit2d.py``, the counterpart of the JAX
  ``pallas2d`` backend; on CPU tensors it runs their plain version.
- ``circuit2d_grid``: the grid-form circuit kernels of
  ``ops/kernels/circuit2d_grid.py``, the counterpart of ``pallas2d_grid``
  (any 2 ≤ n ≤ 24 when named).
- ``blocked2d``: the plain (R, C) matmul formulation, autograd through it.
- ``einsum``: gate-by-gate contractions on the (2,)*n tensor.
- ``structured2d`` (``bn_structured`` only): the plain torch flip-select
  oracle ``sim.structured.make_structured_probs_fn``, named as the JAX
  backend it mirrors.
``auto`` picks ``circuit2d`` for 2 ≤ n ≤ 17 and ``circuit2d_grid`` for
18 ≤ n ≤ 24, for every ansatz. Outside those ranges it picks ``einsum``
for the reference ansätze and raises for ``bn_structured``. The JAX package
runs ``bn_structured`` on XLA executors, never on its circuit kernels; here
the kernels take it, with one CNOT map per layer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bits import generate_all_binary_outcomes
from ..ops.kernels import circuit2d, circuit2d_grid
from ..sim.ansatz import ansatz_probs, num_ansatz_params
from ..sim.blocked2d import make_blocked2d_probs_fn
from ..sim.structured import check_edges, make_structured_probs_fn

BACKENDS = ("circuit2d", "circuit2d_grid", "blocked2d", "einsum", "structured2d")


class QuantumBornMachine:
    def __init__(self, num_latent_vars: int, ansatz_layers: int = 1,
                 ansatz_type: str = "hardware_efficient",
                 init_method: str = "small_random", backend: str = "auto",
                 dtype=torch.float32, device="cuda", edges=None):
        n = num_latent_vars
        self.num_latent_vars = n
        self.ansatz_layers = ansatz_layers
        self.ansatz_type = ansatz_type
        self.init_method = init_method
        self.dtype = dtype
        self.device = torch.device(device)
        self.num_params = num_ansatz_params(n, ansatz_layers, ansatz_type)
        structured = ansatz_type == "bn_structured"
        self.edges = None
        if structured:
            if edges is None:
                raise ValueError("ansatz_type='bn_structured' requires edges= "
                                 "(see sim.structured.latent_edges)")
            self.edges = check_edges(n, edges)
        if backend == "auto":
            if circuit2d.MIN_QUBITS <= n <= circuit2d.MAX_QUBITS:
                backend = "circuit2d"
            elif circuit2d_grid.AUTO_MIN_QUBITS <= n <= circuit2d_grid.MAX_QUBITS:
                backend = "circuit2d_grid"
            elif structured:
                raise ValueError(f"bn_structured runs on the circuit kernels for "
                                 f"{circuit2d.MIN_QUBITS} <= n <= {circuit2d_grid.MAX_QUBITS}, "
                                 f"got {n}; name backend='structured2d' for the plain oracle")
            else:
                backend = "einsum"
        if backend not in BACKENDS:
            raise ValueError(f"backend must be auto or one of {BACKENDS}, got {backend!r}")
        if structured and backend in ("blocked2d", "einsum"):
            raise ValueError(f"backend {backend!r} builds the reference ansätze; bn_structured "
                             "runs on circuit2d, circuit2d_grid or structured2d")
        if backend == "structured2d" and not structured:
            raise ValueError("backend 'structured2d' runs the bn_structured ansatz only")
        self.backend = backend
        if backend == "circuit2d":
            self._probs = circuit2d.make_circuit2d_probs_fn(n, ansatz_layers, ansatz_type,
                                                            self.edges)
        elif backend == "circuit2d_grid":
            self._probs = circuit2d_grid.make_circuit2d_grid_probs_fn(n, ansatz_layers,
                                                                      ansatz_type, self.edges)
        elif backend == "structured2d":
            self._probs = make_structured_probs_fn(n, ansatz_layers, self.edges)
        elif backend == "blocked2d":
            self._probs = make_blocked2d_probs_fn(n, ansatz_layers, ansatz_type)
        else:
            self._probs = lambda p: ansatz_probs(p, n, ansatz_layers, ansatz_type)
        self._all_outcome_tuples = None

    def init(self, generator: torch.Generator) -> torch.Tensor:
        """θ init: ``zero``, ``small_random`` (0.1·N(0,1)) or ``random``
        (U[0, 2π)), drawn on the host from ``generator``."""
        m = self.init_method
        if m == "zero":
            theta = torch.zeros(self.num_params, dtype=torch.float64)
        elif m == "small_random":
            theta = 0.1 * torch.randn(self.num_params, generator=generator, dtype=torch.float64)
        else:
            theta = 2.0 * np.pi * torch.rand(self.num_params, generator=generator,
                                             dtype=torch.float64)
        return theta.to(device=self.device, dtype=self.dtype)

    def probs(self, params: torch.Tensor) -> torch.Tensor:
        """Analytic q_θ(z) over all 2^n outcomes (|ψ|²)."""
        return self._probs(params)

    def get_prob_dict(self, params: torch.Tensor) -> dict:
        with torch.no_grad():
            p = self.probs(params).detach().cpu().numpy()
        if self._all_outcome_tuples is None:
            self._all_outcome_tuples = generate_all_binary_outcomes(self.num_latent_vars)
        return {t: float(p[i]) for i, t in enumerate(self._all_outcome_tuples)}
