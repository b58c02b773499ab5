"""The n <= 17 circuit forward kernel (``csrc/circuit2d_fwd.cuh``), one
persistent kernel whose phases share two buffers (X and tmp), through its
torch mirror ``circuit2d_forward_phased_plain``: the same closed-form first
product, 32x16 units with four-way K-split sums, and scatter store, with each
phase's outputs poisoned with NaN before the phase runs, so that a phase
reading what it writes fails here. The kernel itself runs only on the card,
in chip_smoke.py.

Float64 on the CPU: the mirror against ``circuit2d_forward_plain`` to 1e-12
of the largest value (summation order only), its probabilities against the
JAX package's ``ansatz_probs`` to 1e-10, and at n = 4 against the TPU kernel
in interpret mode (float32) to 1e-6, as tests/test_torch_circuit.py holds
the plain forward."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensornetworks_tpu.ops.pallas.circuit2d import make_pallas_circuit2d_probs
from tensornetworks_tpu.sim import ansatz_probs as j_ansatz_probs
from tensornetworks_tpu.sim.structured import make_structured_probs_fn as j_structured
from tensornetworks_tpu_torch.ops.kernels import _lib
from tensornetworks_tpu_torch.ops.kernels import circuit2d as kc
from tensornetworks_tpu_torch.runners import probe_kernels
from tensornetworks_tpu_torch.sim import gates as tgates
from tensornetworks_tpu_torch.sim.ansatz import num_ansatz_params

HE = "hardware_efficient"
CASES = [(a, n, L) for a in (HE, "basic") for n in (2, 3, 5, 8, 13) for L in (1, 2, 3, 4)]


def _theta(n, L, ansatz, seed):
    return np.random.default_rng(seed).uniform(0, 2 * np.pi, num_ansatz_params(n, L, ansatz))


def _planes(th, plan):
    Mr, Mc = tgates.rotation_operators(th, plan.n, plan.layers, plan.per_qubit)
    return [t.contiguous() for t in (Mr.real, Mr.imag, Mc.real, Mc.imag)]


@pytest.mark.parametrize("ansatz,n,L", CASES)
def test_phased_forward_matches_plain_and_jax(ansatz, n, L):
    plan = kc.CircuitPlan(n, L, ansatz)
    th = _theta(n, L, ansatz, seed=7 * n + L)
    planes = _planes(torch.as_tensor(th), plan)
    before = dict(_lib.LAUNCHES)
    got = kc.circuit2d_forward_phased_plain(*planes, plan)
    want = kc.circuit2d_forward_plain(*planes, plan)
    assert _lib.LAUNCHES == before
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-12 * float(b.abs().max()))
    p_j = np.asarray(j_ansatz_probs(jnp.asarray(th), n, L, ansatz, dtype=jnp.complex128))
    np.testing.assert_allclose(got[0].reshape(-1).numpy(), p_j, atol=1e-10, rtol=0)


# bn_structured: one CNOT map per layer (the DAG's CNOTs on even layers, its
# CZs on odd ones), with high→low and repeated edges and none at all.
BN_CASES = [(3, 2, [(0, 1), (1, 2)]), (5, 4, [(4, 0), (0, 3), (0, 3), (2, 1)]),
            (8, 3, [(0, 2), (2, 5), (1, 7), (5, 6), (7, 3)]), (13, 5, [(12, 0), (3, 9), (6, 7)]),
            (6, 3, [])]


@pytest.mark.parametrize("n,L,edges", BN_CASES)
def test_phased_forward_matches_plain_and_jax_structured(n, L, edges):
    plan = kc.CircuitPlan(n, L, "bn_structured", edges)
    th = np.random.default_rng(n + L).uniform(0, 2 * np.pi, 3 * L * n)
    planes = _planes(torch.as_tensor(th), plan)
    got = kc.circuit2d_forward_phased_plain(*planes, plan)
    want = kc.circuit2d_forward_plain(*planes, plan)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-12 * float(b.abs().max()))
    p_j = np.asarray(j_structured(n, L, edges, dtype=jnp.complex128)(jnp.asarray(th)))
    np.testing.assert_allclose(got[0].reshape(-1).numpy(), p_j, atol=1e-10, rtol=0)


@pytest.mark.parametrize("ansatz", [HE, "basic"])
def test_phased_forward_matches_pallas_kernel_in_interpret_mode(ansatz):
    n, L = 4, 3
    plan = kc.CircuitPlan(n, L, ansatz)
    th = _theta(n, L, ansatz, seed=31)
    p_j = np.asarray(make_pallas_circuit2d_probs(n, L, ansatz, interpret=True)(
        jnp.asarray(th, jnp.float32)))
    probs = kc.circuit2d_forward_phased_plain(*_planes(torch.as_tensor(th), plan), plan)[0]
    np.testing.assert_allclose(probs.reshape(-1).numpy(), p_j, atol=1e-6)


@pytest.mark.parametrize("n,units", [(2, 1), (3, 1), (5, 1), (13, 16), (15, 64), (16, 128),
                                     (17, 256)])
def test_forward_units_cover_each_product_once(n, units):
    """The units of a phase: 32x16 tiles, ragged at the edges, each output
    of the (R, C) product in exactly one; at n = 16, 128 of them."""
    plan = kc.CircuitPlan(n, 1, HE)
    tiles = kc.forward_units(plan.R, plan.C)
    assert len(tiles) == units
    cover = np.zeros((plan.R, plan.C), dtype=int)
    for m0, m1, n0, n1 in tiles:
        assert 0 < m1 - m0 <= kc.UNIT_M and 0 < n1 - n0 <= kc.FWD_UNIT_N
        cover[m0:m1, n0:n1] += 1
    assert (cover == 1).all()


def test_phased_forward_reads_no_buffer_it_writes():
    """A closed-form first phase that left tmp unset, or a scatter that
    missed an element, would leave NaN: at L = 4 with the wall every X
    element is written once per layer."""
    n, L = 6, 4
    plan = kc.CircuitPlan(n, L, HE)
    planes = _planes(torch.as_tensor(_theta(n, L, HE, seed=5)), plan)
    probs, xr, xi = kc.circuit2d_forward_phased_plain(*planes, plan)
    assert all(bool(torch.isfinite(t).all()) for t in (probs, xr, xi))
    dst, _ = plan.tables("cpu")
    assert sorted(dst.tolist()) == list(range(2**n))  # the scatter is a bijection
    np.testing.assert_allclose(float(probs.sum()), 1.0, atol=1e-12)


def test_probe_finds_its_stamp_sites():
    """``runners/probe_kernels`` stamps copies of the persistent kernels (the
    FP32 ones and the bf16 cluster kernels) by text: every site it edits is
    still in the sources, the per-phase marks once per kernel and the grid
    barriers at each of their sites (``probe_kernels.sites``)."""
    for name, edits in probe_kernels.EDITS:
        text = (_lib.CSRC / name).read_text()
        for old, _ in edits:
            assert text.count(old) == probe_kernels.sites(name, old), (name, old[:40])
