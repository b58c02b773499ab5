"""Quantum Born machine on the port's statevector simulator.

Counterpart of ``tensornetworks_tpu/models/born_quantum.py``, unconditioned,
for the reference ansätze (``hardware_efficient``, ``all_to_all``,
``basic``) and the DAG-structured ``bn_structured``, whose entanglers follow
``edges`` (required; see ``sim.structured.latent_edges``). ``probs(params)``
is the analytic |ψ(θ)|² over all 2^n outcomes; gradients flow through torch
autograd. ``log_probs``, ``log_q`` (log q at sampled bit rows) and
``sample`` (by the inverse CDF, uniforms from a generator) build on it.

Backends (all give the same distribution):
- ``circuit2d``: the hand-written CUDA circuit kernels (forward and adjoint
  backward) of ``ops/kernels/circuit2d.py``, the counterpart of the JAX
  ``pallas2d`` backend; on CPU tensors it runs their plain version.
- ``circuit2d_grid``: the grid-form circuit kernels of
  ``ops/kernels/circuit2d_grid.py``, the counterpart of ``pallas2d_grid``
  (any 2 ≤ n ≤ 24 when named).
- ``blocked``: the JAX package's blocked executor (``sim/blocked.py``),
  block matmuls on the flat state with no kernel and no 24-qubit limit;
  with ``grad_method="adjoint"`` its backward is the adjoint sweep of
  ``sim/blocked_adjoint.py`` (two states live whatever the depth), and
  ``remat_layers`` checkpoints each layer under autograd.
- ``blocked2d``: the plain (R, C) matmul formulation, autograd through it.
- ``einsum``: gate-by-gate contractions on the (2,)*n tensor.
- ``structured2d`` (``bn_structured`` only): the plain torch flip-select
  oracle ``sim.structured.make_structured_probs_fn``, named as the JAX
  backend it mirrors.
``auto`` picks ``circuit2d`` for 2 ≤ n ≤ 17 and ``circuit2d_grid`` for
18 ≤ n ≤ 24, for every ansatz; from 25 qubits (and for
``grad_method="adjoint"``) ``blocked`` for the reference ansätze, and below
2 ``einsum``. ``bn_structured`` raises outside 2 ≤ n ≤ 24. The JAX package
runs ``bn_structured`` on XLA executors, never on its circuit kernels; here
the kernels take it, with one CNOT map per layer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bits import generate_all_binary_outcomes, torch_bits_to_index
from ..ops.kernels import circuit2d, circuit2d_grid
from ..sim.ansatz import ansatz_probs, num_ansatz_params
from ..sim.blocked import make_blocked_probs_fn
from ..sim.blocked2d import make_blocked2d_probs_fn
from ..sim.blocked_adjoint import make_blocked_adjoint_probs_fn
from ..sim.sampling import draw_uniforms, sample_bits
from ..sim.structured import check_edges, make_structured_probs_fn

BACKENDS = ("circuit2d", "circuit2d_grid", "blocked", "blocked2d", "einsum", "structured2d")
LOG_PROB_EPS = 1e-9  # the reference's clamp, quantum_born_machine.py:188


class QuantumBornMachine:
    def __init__(self, num_latent_vars: int, ansatz_layers: int = 1,
                 ansatz_type: str = "hardware_efficient",
                 init_method: str = "small_random", backend: str = "auto",
                 dtype=torch.float32, device="cuda", edges=None, block: int = 8,
                 remat_layers: bool = False, grad_method: str = "autodiff"):
        n = num_latent_vars
        self.num_latent_vars = n
        self.ansatz_layers = ansatz_layers
        self.ansatz_type = ansatz_type
        self.init_method = init_method
        self.dtype = dtype
        self.device = torch.device(device)
        self.num_params = num_ansatz_params(n, ansatz_layers, ansatz_type)
        structured = ansatz_type == "bn_structured"
        if grad_method not in ("autodiff", "adjoint"):
            raise ValueError(f"grad_method must be autodiff|adjoint, got {grad_method!r}")
        if grad_method == "adjoint" and structured:
            raise ValueError("grad_method='adjoint' covers the blocked reference ansätze only "
                             "(hardware_efficient/basic/all_to_all)")
        self.grad_method = grad_method
        self.edges = None
        if structured:
            if edges is None:
                raise ValueError("ansatz_type='bn_structured' requires edges= "
                                 "(see sim.structured.latent_edges)")
            self.edges = check_edges(n, edges)
        if backend == "auto" and grad_method == "adjoint":
            backend = "blocked"
        if backend == "auto":
            if circuit2d.MIN_QUBITS <= n <= circuit2d.MAX_QUBITS:
                backend = "circuit2d"
            elif circuit2d_grid.AUTO_MIN_QUBITS <= n <= circuit2d_grid.MAX_QUBITS:
                backend = "circuit2d_grid"
            elif structured:
                raise ValueError(f"bn_structured runs on the circuit kernels for "
                                 f"{circuit2d.MIN_QUBITS} <= n <= {circuit2d_grid.MAX_QUBITS}, "
                                 f"got {n}; name backend='structured2d' for the plain oracle")
            elif n > circuit2d_grid.MAX_QUBITS:
                backend = "blocked"
            else:
                backend = "einsum"
        if backend not in BACKENDS:
            raise ValueError(f"backend must be auto or one of {BACKENDS}, got {backend!r}")
        if structured and backend in ("blocked", "blocked2d", "einsum"):
            raise ValueError(f"backend {backend!r} builds the reference ansätze; bn_structured "
                             "runs on circuit2d, circuit2d_grid or structured2d")
        if grad_method == "adjoint" and backend != "blocked":
            raise ValueError(f"grad_method='adjoint' requires the 'blocked' backend "
                             f"(got {backend!r})")
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
        elif backend == "blocked":
            cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
            if grad_method == "adjoint":
                self._probs = make_blocked_adjoint_probs_fn(n, ansatz_layers, ansatz_type,
                                                            block=block, dtype=cdtype)
            else:
                self._probs = make_blocked_probs_fn(n, ansatz_layers, ansatz_type, block=block,
                                                    dtype=cdtype, remat_layers=remat_layers)
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

    def log_probs(self, params: torch.Tensor) -> torch.Tensor:
        return torch.log(self.probs(params).clamp(min=LOG_PROB_EPS))

    def log_q(self, params: torch.Tensor, z_samples: torch.Tensor) -> torch.Tensor:
        """log q_θ(z) at sample bit rows (..., n), by a gather."""
        return self.log_probs(params)[torch_bits_to_index(z_samples)]

    def sample(self, generator: torch.Generator, params: torch.Tensor,
               num_samples: int) -> torch.Tensor:
        """(num_samples, n) float32 bit rows drawn from q_θ by the inverse
        CDF, with uniforms from ``generator`` (on the parameters' device)."""
        p = self.probs(params)
        p = p / p.sum()
        return sample_bits(p, draw_uniforms(generator, num_samples, p.dtype, p.device),
                           self.num_latent_vars)

    def get_prob_dict(self, params: torch.Tensor) -> dict:
        with torch.no_grad():
            p = self.probs(params).detach().cpu().numpy()
        if self._all_outcome_tuples is None:
            self._all_outcome_tuples = generate_all_binary_outcomes(self.num_latent_vars)
        return {t: float(p[i]) for i, t in enumerate(self._all_outcome_tuples)}
