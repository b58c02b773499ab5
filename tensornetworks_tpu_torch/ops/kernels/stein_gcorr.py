"""The recombination of the n+1-column Stein matvec: the ``stein_gcorr`` kernel.

The gcorr form of ``K_p q`` (``ops/stein.py``) pushes only the n+1 columns
``V = [q; S_t∘q]`` through ``K = A^{⊗n}`` and gets the other 2n columns of
the 3n+1 form in closed form, each a 2x2 along one bit of an
already-applied column. With ``P0 = K q``, ``Q_t = K(S_t∘q)`` and ``m_t =
1 << (n-1-t)`` (bit t, most significant first), ``y = K_p q`` is

    y[i] = Σ_t S_t[i]·Q_t[i] + w1·(Rv[i]·P0[i] + Σ_t Q_t[i]) + w0·P0[i]
           + Σ_t [α·(S_t[i]·P0[i^m_t] + Q_t[i^m_t]) + γ·P0[i^m_t]]

(``Rv = Σ_t S_t``; α, γ, w1, w0 from ``gcorr_coefficients``). The JAX
package evaluates the flip sum in XLA (``stein_matvec_gcorr_tables`` in
``tensornetworks_tpu/ops/stein.py``, three TPU layouts of it:
per-bit sublane swaps, permutation matmuls, a folded hybrid) and has no
Pallas kernel for it. Here it is one launch of ``csrc/stein_gcorr.cu``: a
gather by ``i ^ m_t`` costs the card nothing, so the pre-flipped score
tables the TPU layouts need are not built. Its least work is bytes: S, Q,
P0 and Rv read once and y written once, (2n+3)·4·2^n bytes.

``gcorr_combine_plain`` is the per-bit flip loop as the JAX ``corr="flips"``
form writes it (flip the pre-flipped score's product, then flip the sum
back): another order than the kernel's gather. The wrapper takes it only for
CPU tensors; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib

MIN_VARS, MAX_VARS = 2, 30


def gcorr_coefficients(a: float, n: int):
    """(α, γ, w1, w0) of the recombination, in float64, for decay factor a
    and n variables. With G = A·diag(0, 1)·A⁻¹ per bit, G00 = -a²/(1-a²);
    c1 = 1 - 1/a, c2 = 1 - a."""
    inv = 1.0 / (1.0 - a * a)
    g00 = -a * a * inv
    c1, c2 = 1.0 - 1.0 / a, 1.0 - a
    alpha = -(c1 - c2) * a * inv
    gamma = -2.0 * (1.0 / a - a) * a * inv
    w1 = -((c1 - c2) * g00 + c2)
    w0 = 2.0 * n * (1.0 - a) - 2.0 * (1.0 / a - a) * g00 * n
    return alpha, gamma, w1, w0


def flip_bit(x: torch.Tensor, t: int, n: int) -> torch.Tensor:
    """``x[..., i ^ (1 << (n-1-t))]``: reverse bit t (most significant
    first) of the trailing 2^n axis."""
    shape = x.shape
    return x.reshape(*shape[:-1], 1 << t, 2, -1).flip(-2).reshape(shape)


def gcorr_combine_plain(P0, Q, St, Rv, a: float, n: int) -> torch.Tensor:
    """The recombination in torch: per bit, ``flip_t(α·(flip_t(S_t)∘P0 +
    Q_t) + γ·P0)`` into one accumulator, then the flip-free terms."""
    alpha, gamma, w1, w0 = gcorr_coefficients(a, n)
    acc = torch.zeros_like(P0)
    for t in range(n):
        F = alpha * (flip_bit(St[t], t, n) * P0 + Q[t]) + gamma * P0
        acc = acc + flip_bit(F, t, n)
    return (St * Q).sum(dim=0) + w1 * (Rv * P0 + Q.sum(dim=0)) + w0 * P0 + acc


def _check(P0, Q, St, Rv, n: int) -> None:
    if not MIN_VARS <= n <= MAX_VARS:
        raise ValueError(f"stein_gcorr: n must be in [{MIN_VARS}, {MAX_VARS}], got {n}")
    shapes = {"P0": (1 << n,), "Q": (n, 1 << n), "St": (n, 1 << n), "Rv": (1 << n,)}
    for name, t in zip(shapes, (P0, Q, St, Rv)):
        if t.device != P0.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"stein_gcorr: {name} must be a contiguous float32 tensor on "
                             f"{P0.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"stein_gcorr: {name} has shape {tuple(t.shape)}, "
                             f"want {shapes[name]}")
        if t.data_ptr() % 16:
            raise ValueError(f"stein_gcorr: {name} must be 16-byte aligned")


def gcorr_combine(P0: torch.Tensor, Q: torch.Tensor, St: torch.Tensor, Rv: torch.Tensor,
                  a: float, n: int) -> torch.Tensor:
    """``K_p q`` from ``P0 = K q`` (2^n,), ``Q = K(S∘q)`` (n, 2^n), the
    score rows ``St`` (n, 2^n) and their sum ``Rv`` (2^n,): the kernel in
    one launch on the card, the plain version on the CPU."""
    if P0.device.type == "cpu":
        return gcorr_combine_plain(P0, Q, St, Rv, a, n)
    _check(P0, Q, St, Rv, n)
    fn = _lib.load("stein_gcorr").tn_stein_gcorr_combine
    y = torch.empty_like(P0)
    _lib.count_launch("stein_gcorr")
    coeffs = [ctypes.c_float(c) for c in gcorr_coefficients(a, n)]
    err = fn(_lib.ptr(P0), _lib.ptr(Q), _lib.ptr(St), _lib.ptr(Rv), _lib.ptr(y), *coeffs, n,
             _lib.stream_ptr(P0.device))
    _lib.check(err, "tn_stein_gcorr_combine")
    return y
