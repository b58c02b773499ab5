"""Adjoint backward for the blocked executor: large-n gradients in the
memory of two states.

Counterpart of ``tensornetworks_tpu/sim/blocked_adjoint.py``. Autograd
through ``make_blocked_probs_fn`` keeps every intermediate state of the
circuit (a 2 GB complex64 vector each at n = 28). The adjoint method keeps
only the final state: the backward walks the blocked layer ops in reverse
and recomputes each earlier state by applying inverse operators (each is
unitary), so the live set is ψ, the cotangent λ and one matmul result,
whatever the depth.

- The unit of the sweep is the blocked layer op: the (2^b, 2^b) block
  operators of ``make_block_matrices_fn``, so every full-state op of the
  backward is the forward's block matmul.
- ψ and λ are two flat (2^n,) complex vectors.
- With both vectors at the stage after block operator M(θ):

      dL/dθ = 2·Re Σ_{xy} (∂M/∂θ)_{xy} · G_{xy},   G = conj(M)·E,
      E_{b'b} = Σ_{a,c} conj(λ_{a b' c}) ψ_{a b c}

  with ψ and λ pulled back through M†, where E is one product per block and
  layer. The θ-derivatives of the small matrix function are left to
  ``torch.autograd`` on ``f(θ) = 2·Re Σ M(θ)∘G``, so they follow the
  forward's rotation fold and block-0 permutation exactly.

No kernel runs here: the JAX package computes this sweep in XLA, without a
Pallas kernel, and the port in plain torch matmuls.
"""

from __future__ import annotations

import torch

from ..ops.kron import apply_adjacent_block
from ..train import span
from .blocked import make_block_matrices_fn, make_blocked_state_fn

# Elements of λ conjugated into one temporary by ``_block_cotangent``
# (128 MB in complex64).
_CHUNK = 1 << 24


def _block_cotangent(psi: torch.Tensor, lam: torch.Tensor, start: int, size: int,
                     n: int) -> torch.Tensor:
    """E_{b'b} = Σ_{a,c} conj(λ_{a b' c}) ψ_{a b c} over the (A, B, C) view
    of both vectors, as a sum of products over chunks of at most
    ``_CHUNK`` elements of λ, each conjugated into a copy of that size."""
    A, B = 1 << start, 1 << size
    C = (1 << n) // (A * B)
    if C == 1:
        psi2, lam2 = psi.reshape(A, B), lam.reshape(A, B)
        k = max(1, _CHUNK // B)
        return sum(torch.conj_physical(lam2[a:a + k]).T @ psi2[a:a + k] for a in range(0, A, k))
    psi3, lam3 = psi.reshape(A, B, C), lam.reshape(A, B, C)
    if A == 1:  # chunks of columns; Eᵀ = Σ ψ λ^H
        k = max(1, _CHUNK // B)
        Et = sum(psi3[0, :, c:c + k] @ torch.conj_physical(lam3[0, :, c:c + k]).T
                 for c in range(0, C, k))
    else:
        k = max(1, _CHUNK // (B * C))
        Et = sum(torch.matmul(psi3[a:a + k], torch.conj_physical(lam3[a:a + k]).mT).sum(dim=0)
                 for a in range(0, A, k))
    return Et.T


class _Program:
    """The blocked circuit the adjoint walks: the forward state function,
    its static entanglers and the block-operator builder."""

    def __init__(self, num_wires: int, layers: int, ansatz_type: str, block: int, dtype):
        self.n, self.layers = num_wires, layers
        self.state_fn = make_blocked_state_fn(num_wires, layers, ansatz_type, block, dtype)
        self.ent = self.state_fn.entanglers
        self.block_matrices = make_block_matrices_fn(num_wires, layers, ansatz_type, block,
                                                     dtype)

    def pull_entanglers(self, v: torch.Tensor, layer: int) -> torch.Tensor:
        """The inverse of the layer's tail (CZ signs, ring wrap, boundary
        CNOTs and chain permutations) on one vector."""
        ent = self.ent
        if ent.cz[layer]:
            v = v * ent.const(("sign", ent.cz[layer]), v)  # ±1: self-inverse
        if ent.ring_cross:
            v = ent.ring_wrap(v)
        if ent.chain:
            for i in range(len(ent.blocks) - 1, 0, -1):
                if ent.perms[i] is not None:
                    v = ent.apply(v, "perm_t", i, *ent.blocks[i])
                v = ent.apply(v, "cnot4", 0, ent.boundaries[i - 1][0], 2)
        return v


class _BlockedAdjoint(torch.autograd.Function):
    """probs = |ψ(θ)|², keeping only the final ψ, with the adjoint sweep as
    its backward. A module-level Function: a class made per executor would
    sit in a reference cycle and keep the executor's 2^n constants alive
    until a garbage collection."""

    @staticmethod
    def forward(ctx, params, prog: _Program):
        with span("circuit.forward"):
            psi = prog.state_fn(params)
            ctx.save_for_backward(params)
            ctx.prog = prog
            if ctx.needs_input_grad[0]:
                ctx.psi = psi
            return psi.real ** 2 + psi.imag ** 2

    @staticmethod
    def backward(ctx, w):
        with span("circuit.backward"):
            (params,) = ctx.saved_tensors
            prog, n = ctx.prog, ctx.prog.n
            psi, ctx.psi = ctx.psi, None
            # p = |ψ|² ⇒ dL/dθ = 2·Re⟨λ|∂ψ/∂θ⟩ with λ = w∘ψ (w real).
            lam = w.to(psi.real.dtype) * psi
            with torch.no_grad():
                mats = prog.block_matrices(params)
            Gs = [[] for _ in prog.ent.blocks]
            # One vector at a time, so that at most three states are live.
            for layer in range(prog.layers - 1, -1, -1):
                psi = prog.pull_entanglers(psi, layer)
                lam = prog.pull_entanglers(lam, layer)
                # The blocks act on disjoint qubits: pull both vectors back
                # through each M† and form its cotangent from the pulled pair.
                for i, (s, bs) in enumerate(prog.ent.blocks):
                    M = mats[i][layer]
                    Mh = torch.conj_physical(M).T.contiguous()
                    psi = apply_adjacent_block(psi, Mh, s, bs, n)
                    lam = apply_adjacent_block(lam, Mh, s, bs, n)
                    Gs[i].append(torch.conj_physical(M) @ _block_cotangent(psi, lam, s, bs, n))
            del psi, lam
            G = [torch.stack(g[::-1]) for g in Gs]
            with torch.enable_grad():
                p = params.detach().requires_grad_(True)
                f = sum(2.0 * (m * g).sum().real for m, g in zip(prog.block_matrices(p), G))
                (grad,) = torch.autograd.grad(f, p)
            return grad, None


def make_blocked_adjoint_probs_fn(num_wires: int, layers: int, ansatz_type: str,
                                  block: int = 8, dtype=torch.complex64):
    """``probs(params)`` of the blocked executor with the adjoint backward.
    The forward is ``make_blocked_state_fn``'s (the same probabilities) and
    keeps only the final state; the three reference ansätze
    (hardware_efficient, basic, all_to_all), unconditioned."""
    prog = _Program(num_wires, layers, ansatz_type, block, dtype)
    return lambda params: _BlockedAdjoint.apply(params, prog)
