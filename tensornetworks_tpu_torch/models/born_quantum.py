"""Quantum Born machine on the port's statevector simulator.

Counterpart of ``tensornetworks_tpu/models/born_quantum.py``, for the
reference ansätze (``hardware_efficient``, ``all_to_all``,
``basic``) and the DAG-structured ``bn_structured``, whose entanglers follow
``edges`` (required; see ``sim.structured.latent_edges``). ``probs(params)``
is the analytic |ψ(θ)|² over all 2^n outcomes; gradients flow through torch
autograd. ``state(params)`` is ψ(θ) itself, as a (2,)*n complex tensor.
``log_probs``, ``log_q`` (log q at sampled bit rows) and ``sample`` (by the
inverse CDF, uniforms from a generator) build on ``probs``.

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

Conditioning (``conditioning_dim`` = d > 0): an RY wall after the Hadamard
wall whose angles come from the observation x, and ``x_condition`` on
``probs``, ``log_probs``, ``log_q``, ``sample`` and ``get_prob_dict``. The
angles are π·x cycled over the qubits, or with ``cond_learned_embedding``
``W·φ(x)``, W (n, 2^d) learned over the 2^d interaction features
``φ(x)_S = Π_{j∈S} x_j`` (subset S by the bits of its index, LSB first);
``cond_embed_per_layer`` scales them per layer and qubit, ``s ⊙ W·φ(x)`` of
shape (L, n). ``cond_reupload`` (bn_structured) puts the wall before every
layer. The parameter vector is θ ⊕ W ⊕ s, the JAX layout; ``init`` sets
W[q, 1 << (q mod d)] = π and s = 1, so that a learned machine starts as the
fixed wall. A conditioned machine runs on the circuit kernels with the
wall folded into their operator planes: ``auto`` picks ``circuit2d`` for
2 ≤ n ≤ 17, ``circuit2d_grid`` for 18 ≤ n ≤ 24 and ``blocked`` otherwise
(the reference ansätze), where the JAX package runs every conditioned
machine on its XLA executors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bits import all_bitstrings, generate_all_binary_outcomes, torch_bits_to_index
from ..ops.kernels import circuit2d, circuit2d_grid
from ..sim.ansatz import ansatz_probs, ansatz_state, num_ansatz_params
from ..sim.blocked import make_blocked_probs_fn, make_blocked_state_fn
from ..sim.blocked2d import make_blocked2d_probs_fn
from ..sim.blocked_adjoint import make_blocked_adjoint_probs_fn
from ..sim.sampling import draw_uniforms, sample_bits
from ..sim.structured import check_edges, make_structured_probs_fn

BACKENDS = ("circuit2d", "circuit2d_grid", "blocked", "blocked2d", "einsum", "structured2d")
CONDITIONED_BACKENDS = ("circuit2d", "circuit2d_grid", "blocked", "structured2d")
MAX_LEARNED_CONDITIONING_DIM = 10  # 2^d interaction features
LOG_PROB_EPS = 1e-9  # the reference's clamp, quantum_born_machine.py:188


class QuantumBornMachine:
    def __init__(self, num_latent_vars: int, ansatz_layers: int = 1,
                 ansatz_type: str = "hardware_efficient",
                 init_method: str = "small_random", backend: str = "auto",
                 dtype=torch.float32, device="cuda", edges=None, block: int = 8,
                 remat_layers: bool = False, grad_method: str = "autodiff",
                 conditioning_dim: int = 0, cond_reupload: bool = False,
                 cond_learned_embedding: bool = False, cond_embed_per_layer: bool = False):
        n = num_latent_vars
        self.num_latent_vars = n
        self.ansatz_layers = ansatz_layers
        self.ansatz_type = ansatz_type
        self.init_method = init_method
        self.dtype = dtype
        self.device = torch.device(device)
        structured = ansatz_type == "bn_structured"
        cond = conditioning_dim > 0
        self.conditioning_dim = conditioning_dim
        self.cond_reupload = cond_reupload
        self.cond_learned_embedding = cond_learned_embedding
        self.cond_embed_per_layer = cond_embed_per_layer
        if cond_reupload and not (cond and structured):
            raise ValueError("cond_reupload requires a conditioned bn_structured Born machine "
                             "(the circuit kernels and the structured executors implement it)")
        if cond_learned_embedding:
            if not cond:
                raise ValueError("cond_learned_embedding requires a conditioned Born machine")
            if conditioning_dim > MAX_LEARNED_CONDITIONING_DIM:
                raise ValueError(f"cond_learned_embedding builds 2^d interaction features; "
                                 f"d={conditioning_dim} is too large")
        if cond_embed_per_layer and not (cond_learned_embedding and cond_reupload):
            raise ValueError("cond_embed_per_layer requires cond_learned_embedding and "
                             "cond_reupload")
        if cond and grad_method == "adjoint":
            raise ValueError("grad_method='adjoint' does not support conditioning")
        self.num_circuit_params = num_ansatz_params(n, ansatz_layers, ansatz_type)
        self._num_embed = n << conditioning_dim if cond_learned_embedding else 0
        self._num_scales = ansatz_layers * n if cond_embed_per_layer else 0
        self.num_params = self.num_circuit_params + self._num_embed + self._num_scales
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
            elif n > circuit2d_grid.MAX_QUBITS or cond:
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
        if cond and backend not in CONDITIONED_BACKENDS:
            raise ValueError(f"conditioned quantum Born machines run on {CONDITIONED_BACKENDS}, "
                             f"got {backend!r}")
        if cond_reupload and backend == "structured2d":
            raise ValueError("cond_reupload is implemented by the circuit kernels; the "
                             "structured2d oracle takes a single wall")
        self.backend = backend
        if backend == "circuit2d":
            self._probs = circuit2d.make_circuit2d_probs_fn(
                n, ansatz_layers, ansatz_type, self.edges, conditioning=cond,
                reupload=cond_reupload)
        elif backend == "circuit2d_grid":
            self._probs = circuit2d_grid.make_circuit2d_grid_probs_fn(
                n, ansatz_layers, ansatz_type, self.edges, conditioning=cond,
                reupload=cond_reupload)
        elif backend == "structured2d":
            self._probs = make_structured_probs_fn(n, ansatz_layers, self.edges,
                                                   conditioning=cond)
        elif backend == "blocked":
            cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
            if grad_method == "adjoint":
                self._probs = make_blocked_adjoint_probs_fn(n, ansatz_layers, ansatz_type,
                                                            block=block, dtype=cdtype)
            else:
                self._probs = make_blocked_probs_fn(n, ansatz_layers, ansatz_type, block=block,
                                                    dtype=cdtype, remat_layers=remat_layers,
                                                    conditioning=cond)
        elif backend == "blocked2d":
            self._probs = make_blocked2d_probs_fn(n, ansatz_layers, ansatz_type)
        else:
            self._probs = lambda p: ansatz_probs(p, n, ansatz_layers, ansatz_type)
        self._block = block
        self._state_fn = getattr(self._probs, "state", None)
        self._all_outcome_tuples = None

    def init(self, generator: torch.Generator) -> torch.Tensor:
        """θ init: ``zero``, ``small_random`` (0.1·N(0,1)) or ``random``
        (U[0, 2π)), drawn on the host from ``generator``; then, for a learned
        embedding, W with W[q, 1 << (q mod d)] = π (the fixed wall's angles)
        and the per-layer scales at 1."""
        m, nc = self.init_method, self.num_circuit_params
        if m == "zero":
            theta = torch.zeros(nc, dtype=torch.float64)
        elif m == "small_random":
            theta = 0.1 * torch.randn(nc, generator=generator, dtype=torch.float64)
        else:
            theta = 2.0 * np.pi * torch.rand(nc, generator=generator, dtype=torch.float64)
        if self._num_embed:
            n, d = self.num_latent_vars, self.conditioning_dim
            W = torch.zeros((n, 1 << d), dtype=torch.float64)
            for q in range(n):
                W[q, 1 << (q % d)] = np.pi
            theta = torch.cat([theta, W.reshape(-1),
                               torch.ones(self._num_scales, dtype=torch.float64)])
        return theta.to(device=self.device, dtype=self.dtype)

    def _interaction_features(self, x: torch.Tensor) -> torch.Tensor:
        """φ(x) (2^d,): the products Π_{j∈S} x_j over all subsets S, subset
        m holding x_j when bit j of m is set (φ_∅ = 1)."""
        d = self.conditioning_dim
        masks = torch.as_tensor(all_bitstrings(d)[:, ::-1].copy(), device=x.device) > 0
        return torch.where(masks, x[None, :], torch.ones_like(x)[None, :]).prod(dim=1)

    def _embed_angles(self, x_condition, params: torch.Tensor) -> torch.Tensor:
        """The wall's angles for the observation x: π·x cycled over the n
        qubits (n,); with the learned embedding W·φ(x) (n,), or with the
        per-layer scales s ⊙ W·φ(x) (L, n)."""
        n = self.num_latent_vars
        x = torch.as_tensor(x_condition, dtype=params.dtype, device=params.device).reshape(-1)
        if not self._num_embed:
            return np.pi * x.repeat(-(-n // x.shape[0]))[:n]
        nc = self.num_circuit_params
        W = params[nc:nc + self._num_embed].reshape(n, 1 << self.conditioning_dim)
        base = W @ self._interaction_features(x)
        if not self._num_scales:
            return base
        s = params[nc + self._num_embed:].reshape(self.ansatz_layers, n)
        return s * base[None, :]

    def probs(self, params: torch.Tensor, x_condition=None) -> torch.Tensor:
        """Analytic q_θ(z) (or q_θ(z | x)) over all 2^n outcomes (|ψ|²)."""
        if self.conditioning_dim == 0:
            if x_condition is not None:
                raise ValueError("x_condition provided but conditioning_dim is 0.")
            return self._probs(params)
        if x_condition is None:
            raise ValueError("x_condition must be provided for a conditioned quantum Born "
                             "machine.")
        return self._probs(params[:self.num_circuit_params],
                           self._embed_angles(x_condition, params))

    def probs_batch(self, params: torch.Tensor, X) -> torch.Tensor:
        """(B, 2^n): q_θ(z | x) for every row x of X (B, d). On the circuit
        kernels θ is folded into the operators once and each row adds its
        wall fold and one launch per direction."""
        if self.conditioning_dim == 0:
            raise ValueError("probs_batch needs a conditioned quantum Born machine")
        circ = params[:self.num_circuit_params]
        angles = [self._embed_angles(x, params) for x in X]
        batch = getattr(self._probs, "batch", None)
        if batch is not None:
            return batch(circ, angles)
        return torch.stack([self._probs(circ, a) for a in angles])

    def state(self, params: torch.Tensor, x_condition=None) -> torch.Tensor:
        """ψ(θ) (or ψ(θ | x)) as a (2,)*n complex tensor, index for index
        the amplitudes of ``probs`` (``|state|² == probs``). On the circuit
        backends it is the final state the forward kernel writes for its
        backward, re-indexed from the (R, C) view, with no autograd graph;
        ``blocked`` runs its state function, ``blocked2d`` and ``einsum``
        the gate-by-gate ansatz. bn_structured exposes probabilities only,
        as in the JAX package."""
        if self.ansatz_type == "bn_structured":
            raise NotImplementedError(
                "bn_structured exposes probabilities only; use probs/sample/log_q")
        if self._state_fn is None:
            n, L, kind = self.num_latent_vars, self.ansatz_layers, self.ansatz_type
            if self.backend == "blocked":
                cdtype = torch.complex128 if self.dtype == torch.float64 else torch.complex64
                self._state_fn = make_blocked_state_fn(n, L, kind, block=self._block,
                                                       dtype=cdtype,
                                                       conditioning=self.conditioning_dim > 0)
            else:
                self._state_fn = lambda p: ansatz_state(p, n, L, kind)
        shape = (2,) * self.num_latent_vars
        if self.conditioning_dim == 0:
            if x_condition is not None:
                raise ValueError("x_condition provided but conditioning_dim is 0.")
            return self._state_fn(params).reshape(shape)
        if x_condition is None:
            raise ValueError("x_condition must be provided for a conditioned quantum Born "
                             "machine.")
        return self._state_fn(params[:self.num_circuit_params],
                              self._embed_angles(x_condition, params)).reshape(shape)

    @property
    def all_outcome_tuples(self) -> list:
        """Every outcome as a tuple of bits, in index order (built on first
        use: 2^n tuples)."""
        if self._all_outcome_tuples is None:
            self._all_outcome_tuples = generate_all_binary_outcomes(self.num_latent_vars)
        return self._all_outcome_tuples

    def log_probs(self, params: torch.Tensor, x_condition=None) -> torch.Tensor:
        return torch.log(self.probs(params, x_condition).clamp(min=LOG_PROB_EPS))

    def log_q(self, params: torch.Tensor, z_samples: torch.Tensor,
              x_condition=None) -> torch.Tensor:
        """log q_θ(z) at sample bit rows (..., n), by a gather."""
        return self.log_probs(params, x_condition)[torch_bits_to_index(z_samples)]

    def sample(self, generator: torch.Generator, params: torch.Tensor,
               num_samples: int, x_condition=None) -> torch.Tensor:
        """(num_samples, n) float32 bit rows drawn from q_θ by the inverse
        CDF, with uniforms from ``generator`` (on the parameters' device)."""
        p = self.probs(params, x_condition)
        p = p / p.sum()
        return sample_bits(p, draw_uniforms(generator, num_samples, p.dtype, p.device),
                           self.num_latent_vars)

    def get_prob_dict(self, params: torch.Tensor, x_condition=None) -> dict:
        with torch.no_grad():
            p = self.probs(params, x_condition).detach().cpu().numpy()
        return {t: float(p[i]) for i, t in enumerate(self.all_outcome_tuples)}
