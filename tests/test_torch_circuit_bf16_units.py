"""The bf16 variants (``high``, ``default``) of circuit kernel 2
(``csrc/circuit_bf16.cuh``: operands split once into bf16 planes,
share-ordered K sums) through its torch mirror
``circuit2d_backward_bf16_phased_plain``, its launch plan (``bf16_plan``)
and units; the forward's bf16 variants (the units' passes) through
``circuit2d_forward_phased_plain``. The kernels themselves run only on the
card, in chip_smoke.py, which also holds ``bf16_plan`` equal to the
library's.

Tolerances, relative to the largest magnitude. The mirrors against the
plain versions (``_pcmm``'s passes) in float64: 1e-12 (the products of bf16
operands are exact; only the order of the sums differs). Against the JAX
package in float64: 1e-4 under ``high`` (a split operand keeps about 16
bits), 5e-2 under ``default`` (8 bits, carried through the layers), the
limits of tests/test_torch_precision.py. Against the TPU kernel in
interpret mode (FP32) under ``high``: 1e-4, as that file holds the plain
version."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensornetworks_tpu.ops.pallas.circuit2d import make_pallas_circuit2d_probs
from tensornetworks_tpu.sim import ansatz_probs as j_ansatz_probs
from tensornetworks_tpu.sim import structured as jst
from tensornetworks_tpu_torch.ops.kernels import _lib
from tensornetworks_tpu_torch.ops.kernels import circuit2d as kc
from tensornetworks_tpu_torch.runners import probe_kernels
from tensornetworks_tpu_torch.sim.ansatz import num_ansatz_params
from tensornetworks_tpu_torch.sim.gates import rotation_operators

HE, BN = "hardware_efficient", "bn_structured"
LIMITS = {"high": 1e-4, "default": 5e-2}
EDGES = {5: [(4, 0), (0, 3), (2, 1)], 7: [(0, 2), (2, 5), (1, 6), (6, 3)], 8: [(0, 7), (3, 4)]}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _case(n, L, ansatz, precision, seed, dtype=torch.float64):
    edges = EDGES[n] if ansatz == BN else None
    plan = kc.CircuitPlan(n, L, ansatz, edges, precision=precision)
    th = np.random.default_rng(seed).uniform(0, 2 * np.pi, num_ansatz_params(n, L, ansatz))
    Mr, Mc = rotation_operators(torch.as_tensor(th, dtype=dtype), n, L, plan.per_qubit)
    planes = [t.contiguous() for t in (Mr.real, Mr.imag, Mc.real, Mc.imag)]
    return plan, th, planes


MIRROR_CASES = [(3, 2, HE), (4, 3, HE), (5, 2, "basic"), (5, 3, BN), (6, 2, HE), (7, 4, BN),
                (8, 2, HE), (9, 2, HE)]


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("n,L,ansatz", MIRROR_CASES)
def test_bf16_mirrors_match_the_plain_versions(n, L, ansatz, precision):
    plan, _, planes = _case(n, L, ansatz, precision, seed=n + L)
    before = dict(_lib.LAUNCHES)
    _, xr, xi = kc.circuit2d_forward_plain(*planes, plan)
    g = torch.as_tensor(np.random.default_rng(n).normal(size=(plan.R, plan.C)))
    got = kc.circuit2d_backward_bf16_phased_plain(*planes, xr, xi, g, plan)
    want = kc.circuit2d_backward_plain(*planes, xr, xi, g, plan)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert _rel(a, b) <= 1e-12
    assert _lib.LAUNCHES == before


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("sms", [1, 2, 3, 7, 64])
def test_bf16_mirrors_at_any_cluster_count(sms, precision):
    """Columns cut in runs of 8 over one to four clusters (sets of cs blocks
    that share an item; n=10: one block a set, so as many sets as SMs),
    items one or more runs wide: the same products, FP32 sums in another
    order (1e-5)."""
    n, L = 10, 2
    plan, _, planes = _case(n, L, HE, precision, seed=1, dtype=torch.float32)
    _, xr, xi = kc.circuit2d_forward_plain(*planes, plan)
    g = torch.as_tensor(np.random.default_rng(3).normal(size=(plan.R, plan.C)),
                        dtype=torch.float32)
    want = kc.circuit2d_backward_plain(*planes, xr, xi, g, plan)
    got = kc.circuit2d_backward_bf16_phased_plain(*planes, xr, xi, g, plan, sms=sms)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-5


def _jax_reference(n, L, ansatz, th, v):
    if ansatz == BN:
        fn = jst.make_structured_probs_fn(n, L, EDGES[n], dtype=jnp.complex128)
    else:
        def fn(p):
            return j_ansatz_probs(p, n, L, ansatz, dtype=jnp.complex128)
    p = np.asarray(fn(jnp.asarray(th)))
    g = np.asarray(jax.grad(lambda q: fn(q) @ jnp.asarray(v))(jnp.asarray(th)))
    return p, g


def _mirror_probs_and_grad(n, L, ansatz, precision, th, v, dtype):
    """probs and d(probs·v)/dθ through the phased mirrors (the forward's units,
    the backward's bf16 kernel), θ's fold by autograd."""
    edges = EDGES[n] if ansatz == BN else None
    plan = kc.CircuitPlan(n, L, ansatz, edges, precision=precision)
    p = torch.as_tensor(th, dtype=dtype).requires_grad_(True)
    Mr, Mc = rotation_operators(p, n, L, plan.per_qubit)
    planes = [Mr.real, Mr.imag, Mc.real, Mc.imag]
    flat = [t.detach().contiguous() for t in planes]
    probs, xr, xi = kc.circuit2d_forward_phased_plain(*flat, plan)
    g = torch.as_tensor(v, dtype=dtype).reshape(plan.R, plan.C)
    grads = kc.circuit2d_backward_bf16_phased_plain(*flat, xr, xi, g, plan)
    torch.autograd.backward(planes, list(grads))
    return probs.reshape(-1).detach().numpy(), p.grad.numpy()


@pytest.mark.parametrize("n,L,ansatz", [(4, 2, HE), (5, 3, BN), (6, 2, HE), (7, 2, BN)])
def test_bf16_mirrors_match_jax_float64(n, L, ansatz):
    th = np.random.default_rng(10 * n + L).uniform(0, 2 * np.pi, num_ansatz_params(n, L, ansatz))
    v = np.random.default_rng(n).normal(size=2**n)
    p_j, g_j = _jax_reference(n, L, ansatz, th, v)
    err = {}
    for prec in ("high", "default"):
        p_t, g_t = _mirror_probs_and_grad(n, L, ansatz, prec, th, v, torch.float64)
        err[prec] = max(_rel(p_t, p_j), _rel(g_t, g_j))
        assert err[prec] <= LIMITS[prec], (prec, err[prec])
    assert err["default"] > err["high"]


def test_bf16_high_mirror_matches_the_pallas_kernel_in_interpret_mode():
    """n=4, HE L=2: the JAX package's TPU kernel (FP32, interpret mode)
    against the bf16 mirrors under ``high`` in FP32."""
    n, L = 4, 2
    th = np.random.default_rng(4).uniform(0, 2 * np.pi, 3 * L * n)
    v = np.random.default_rng(5).normal(size=2**n)
    fn = make_pallas_circuit2d_probs(n, L, HE, interpret=True)
    th32, v32 = jnp.asarray(th, jnp.float32), jnp.asarray(v, jnp.float32)
    p_j = np.asarray(fn(th32))
    g_j = np.asarray(jax.grad(lambda p: fn(p) @ v32)(th32))
    p_t, g_t = _mirror_probs_and_grad(n, L, HE, "high", th, v, torch.float32)
    assert _rel(p_t, p_j) <= LIMITS["high"]
    assert _rel(g_t, g_j) <= LIMITS["high"]


UNIT_NS = [3, 5, 12, 15, 16, 17]
# The H100 SXM's SMs (the kernel's card here) and the H100 PCIe's.
SM_COUNTS = [kc.BF16_SMS, 114]


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("n", UNIT_NS)
def test_bf16_units_cover_each_product_once(n, precision, sms):
    """Each output of every product in exactly one unit, inside its tile,
    with sets of cs blocks over the card's SMs; at n=16 one wave: at most
    one item a set."""
    R, C = 1 << ((n + 1) // 2), 1 << (n // 2)
    bp = kc.bf16_plan(n, precision, sms)
    assert bp["smem"] <= kc.BF16_SMEM_MAX
    units = kc.bf16_backward_units(n, precision, sms)
    cover = np.zeros((R, C), dtype=int)
    for _, rank, m0, m1, n0, n1 in units["pulls"]:
        assert 0 < m1 - m0 <= bp["t1"] and 0 < n1 - n0 <= bp["t0"] and rank < bp["cs"]
        cover[m0:m1, n0:n1] += 1
    assert (cover == 1).all()
    for name, side, tm in (("dmr", R, 32), ("dmc", C, bp["t2"])):
        grad = np.zeros((side, side), dtype=int)
        for m0, m1, n0, n1 in units[name]:
            assert 0 < m1 - m0 <= tm and 0 < n1 - n0 <= 32
            grad[m0:m1, n0:n1] += 1
        assert (grad == 1).all()
    tiles = kc.bf16_warp_tiles(bp["t1"], bp["t0"], 2)
    assert tiles in (1, 2, 4, 8)  # a 16 x 16 warp tile a warp
    assert kc.bf16_k_shares(tiles) * tiles == 8
    if n == 16:  # one wave: at most one item a set of blocks
        assert bp["items"] * bp["cs"] <= sms and bp["items"] <= sms // bp["cs"]


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("n,L,ansatz", [(3, 2, "basic"), (5, 2, BN), (6, 1, HE), (7, 3, BN),
                                        (8, 3, HE), (9, 4, HE)])
def test_bf16_phases_read_no_buffer_they_write(n, L, ansatz, precision):
    """Every phase (between grid barriers) fills what it writes with NaN
    before it reads anything, no phase reads what it writes, and the
    results are finite: 3L + 1 phases (3L grid barriers), the split
    buffers among the first phase's outputs."""
    plan, _, planes = _case(n, L, ansatz, precision, seed=n)
    _, xr, xi = kc.circuit2d_forward_plain(*planes, plan)
    g = torch.as_tensor(np.random.default_rng(0).normal(size=(plan.R, plan.C)))
    log = kc._PhaseLog()
    grads = kc.circuit2d_backward_bf16_phased_plain(*planes, xr, xi, g, plan, log=log)
    assert len(log.reads) == 3 * L + 1
    assert {"mr", "mc"} <= log.writes[f"phi1_{L - 1}"]
    for phase, reads in log.reads.items():
        assert not reads & log.writes[phase], phase
    assert all(bool(torch.isfinite(t).all()) for t in grads)


def test_probe_stamps_every_kernel():
    """The probe's barrier counts are the kernels' phase counts."""
    L = 8
    for precision in ("highest", "high", "default"):
        assert probe_kernels.barriers(precision, L, backward=False) == 2 * L - 1
        assert probe_kernels.barriers(precision, L, backward=True) == 3 * L
