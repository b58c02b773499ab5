"""The tile arithmetic of two circuit kernels, through torch/numpy mirrors
that repeat it (the kernels themselves run only on the card, in
chip_smoke.py):

- the n <= 17 backward (``csrc/circuit2d_bwd.cuh``), one persistent kernel
  whose phases share four scratch buffers and sum each product over four
  K-ranges: ``circuit2d_backward_phased_plain`` runs the same phases,
  buffers and K-split sums, and poisons each phase's outputs with NaN before
  the phase runs, so that a phase reading what it writes fails here;
- the scatter epilogue of the large GEMM loop (``csrc/tn_gemm.cuh``), which
  splits the CNOT map of the flat index m*N + n as dst(m*N) ^ dst(n):
  ``scatter_targets`` against ``expand_maps``, exactly.

Float64 on the CPU: the mirror against ``circuit2d_backward_plain`` to 1e-12
of the largest gradient (summation order only), and its θ-gradient through
an autograd Function against ``jax.grad`` of the JAX package's circuit to
1e-10, as tests/test_torch_circuit.py holds the plain backward."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensornetworks_tpu.sim import ansatz_probs as j_ansatz_probs
from tensornetworks_tpu.sim.structured import make_structured_probs_fn as j_structured
from tensornetworks_tpu_torch.ops.kernels import _lib
from tensornetworks_tpu_torch.ops.kernels import circuit2d as kc
from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg
from tensornetworks_tpu_torch.sim import gates as tgates
from tensornetworks_tpu_torch.sim.ansatz import num_ansatz_params

HE = "hardware_efficient"


def _theta(n, L, ansatz, seed):
    return np.random.default_rng(seed).uniform(0, 2 * np.pi, num_ansatz_params(n, L, ansatz))


def _planes(th, plan):
    Mr, Mc = tgates.rotation_operators(th, plan.n, plan.layers, plan.per_qubit)
    return [t.contiguous() for t in (Mr.real, Mr.imag, Mc.real, Mc.imag)]


class PhasedCircuit(torch.autograd.Function):
    """probs (R, C) of the operator planes, with the phased mirror of the
    persistent backward kernel as its backward."""

    @staticmethod
    def forward(ctx, mr_re, mr_im, mc_re, mc_im, plan):
        probs, xr, xi = kc.circuit2d_forward_plain(mr_re, mr_im, mc_re, mc_im, plan)
        ctx.plan = plan
        ctx.save_for_backward(mr_re, mr_im, mc_re, mc_im, xr, xi)
        return probs

    @staticmethod
    def backward(ctx, g):
        mr_re, mr_im, mc_re, mc_im, xr, xi = ctx.saved_tensors
        return (*kc.circuit2d_backward_phased_plain(mr_re, mr_im, mc_re, mc_im, xr, xi,
                                                    g.contiguous(), ctx.plan), None)


@pytest.mark.parametrize("ansatz,n,L", [(HE, n, L) for n in (3, 5, 8, 13) for L in (2, 3, 4)]
                         + [("basic", 5, 2), ("all_to_all", 4, 3), (HE, 2, 1)])
def test_phased_mirror_matches_backward_plain(ansatz, n, L):
    plan = kc.CircuitPlan(n, L, ansatz)
    planes = _planes(torch.as_tensor(_theta(n, L, ansatz, seed=n + L)), plan)
    _, xr, xi = kc.circuit2d_forward_plain(*planes, plan)
    g = torch.as_tensor(np.random.default_rng(100 + n).normal(size=(plan.R, plan.C)))
    before = dict(_lib.LAUNCHES)
    got = kc.circuit2d_backward_phased_plain(*planes, xr, xi, g, plan)
    want = kc.circuit2d_backward_plain(*planes, xr, xi, g, plan)
    assert _lib.LAUNCHES == before
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-12 * float(b.abs().max()))


@pytest.mark.parametrize("n,L", [(3, 2), (3, 4), (5, 3), (8, 4), (13, 2), (13, 3)])
def test_phased_mirror_theta_grad_matches_jax_grad(n, L):
    plan = kc.CircuitPlan(n, L, HE)
    th = _theta(n, L, HE, seed=7 * n + L)
    v = np.random.default_rng(n * L).normal(size=2**n)
    g_j = np.asarray(jax.grad(lambda p: j_ansatz_probs(p, n, L, HE, dtype=jnp.complex128)
                              @ jnp.asarray(v))(jnp.asarray(th)))
    p = torch.as_tensor(th).requires_grad_(True)
    probs = PhasedCircuit.apply(*_planes(p, plan), plan).reshape(-1)
    (probs @ torch.as_tensor(v)).backward()
    np.testing.assert_allclose(p.grad.numpy(), g_j, atol=1e-10, rtol=0)


# bn_structured: one CNOT map per layer, with high→low and repeated edges.
BN_CASES = [(3, 2, [(0, 1), (1, 2)]), (5, 4, [(4, 0), (0, 3), (0, 3), (2, 1)]),
            (8, 3, [(0, 2), (2, 5), (1, 7), (5, 6), (7, 3)]), (13, 4, [(12, 0), (3, 9), (6, 7)])]


@pytest.mark.parametrize("n,L,edges", BN_CASES)
def test_phased_mirror_structured_matches_plain_and_jax_grad(n, L, edges):
    plan = kc.CircuitPlan(n, L, "bn_structured", edges)
    th = np.random.default_rng(n * L).uniform(0, 2 * np.pi, 3 * L * n)
    planes = _planes(torch.as_tensor(th), plan)
    _, xr, xi = kc.circuit2d_forward_plain(*planes, plan)
    g = torch.as_tensor(np.random.default_rng(200 + n).normal(size=(plan.R, plan.C)))
    got = kc.circuit2d_backward_phased_plain(*planes, xr, xi, g, plan)
    want = kc.circuit2d_backward_plain(*planes, xr, xi, g, plan)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-12 * float(b.abs().max()))
    v = np.random.default_rng(n).normal(size=2**n)
    fn = j_structured(n, L, edges, dtype=jnp.complex128)
    g_j = np.asarray(jax.grad(lambda p: fn(p) @ jnp.asarray(v))(jnp.asarray(th)))
    p = torch.as_tensor(th).requires_grad_(True)
    probs = PhasedCircuit.apply(*_planes(p, plan), plan).reshape(-1)
    (probs @ torch.as_tensor(v)).backward()
    np.testing.assert_allclose(p.grad.numpy(), g_j, atol=1e-10, rtol=0)


@pytest.mark.parametrize("K", [1, 2, 16, 17, 48, 64, 100, 256])
def test_ksplit_product_matches_plain_product(K):
    """The four K-ranges of whole 16-deep steps, the last ones empty when K
    is short, sum to the product."""
    rng = np.random.default_rng(K)
    a_re, a_im, b_re, b_im = (torch.as_tensor(rng.normal(size=s))
                              for s in ((5, K), (5, K), (K, 3), (K, 3)))
    got = kc._ksplit_cmm(a_re, a_im, b_re, b_im)
    want = kc._cmm(a_re, a_im, b_re, b_im)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12 * K)


@pytest.mark.parametrize("grid,n", [(False, 5), (False, 8), (False, 17), (True, 5),
                                    (True, 8), (True, 18), (True, 19), (True, 21)])
def test_scatter_split_reproduces_expand_maps(grid, n):
    """d = dst(m·N) ⊕ dst(n) and the sign at d, for every output of the
    product at n ≤ 8 and a sample of 4096 (with both ends) above."""
    plan = (kg.GridPlan if grid else kc.CircuitPlan)(n, 3, HE)
    N = plan.C
    if n <= 8:
        idx = np.arange(1 << n, dtype=np.int64)
    else:
        rng = np.random.default_rng(n)
        idx = np.concatenate([[0, (1 << n) - 1], rng.integers(0, 1 << n, 4094)])
    rows = plan.rows[0]  # HE: every layer's map is the same
    dst, sign = kc.expand_maps(rows, plan.cz, "cpu", index=idx)
    for row in range(len(plan.cz)):
        d, s = kc.scatter_targets(rows, plan.cz[row], idx // N, idx % N, N)
        np.testing.assert_array_equal(d, dst.numpy())
        np.testing.assert_array_equal(s, sign[row].numpy())
    if n <= 8:  # the sampled evaluation is the full table's
        full_dst, full_sign = kc.expand_maps(rows, plan.cz, "cpu")
        np.testing.assert_array_equal(full_dst.numpy(), dst.numpy())
        np.testing.assert_array_equal(full_sign.numpy(), sign.numpy())


def test_device_masks_are_rows_then_cz():
    """Row 2l of the table holds layer l's row masks, row 2l + 1 its CZ
    masks (csrc/circuit_units.cuh load_spec)."""
    plan = kc.CircuitPlan(7, 3, HE)
    masks = plan.device_masks("cpu")
    assert masks.dtype == torch.int32 and tuple(masks.shape) == (6, 7)
    got = masks.numpy().view(np.uint32)
    for layer in range(3):
        np.testing.assert_array_equal(got[2 * layer], plan.rows[layer])
        np.testing.assert_array_equal(got[2 * layer + 1], plan.cz[layer])
    assert (plan.rows == plan.rows[0]).all()  # HE: one chain map on every layer
    assert plan.device_masks("cpu") is masks
