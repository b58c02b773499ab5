"""The port's precision policy against the JAX package's: the kernel dot
precision (``ops/kernels/precision.py``, ``TNTPU_KERNEL_PRECISION``), the
training context ``engines.common.highest_matmul_precision``
(``TNTPU_MATMUL_PRECISION``), ``compute_dtype`` on the Kronecker and Stein
operators, and ``SteinOperator``'s ``use_pallas``.

The circuit kernels' plain versions emulate the bf16 tensor-core passes of
``high`` (three passes) and ``default`` (one) exactly up to the order of
their sums. Tolerances, relative to the largest magnitude: under ``high``
1e-4 of the JAX package's float64 forward and gradient (a split operand
keeps about 16 bits, 2^-17 ≈ 7.6e-6 relative; the CPU reads 1-2e-5); under
``default`` 5e-2 (8 bits, 2^-9 ≈ 2e-3 per operand, carried through the
layers; the CPU reads up to 1.5e-2); ``highest`` bit for bit the FP32 plain
versions as they were before the knob. ``compute_dtype=bfloat16`` against
the JAX functions with ``jnp.bfloat16``: 2e-2, the JAX package's own bound
(tests/test_coverage_branches.py). The CUDA kernels themselves run only on
the card, in chip_smoke.py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensornetworks_tpu.core import get_random_chain_network as j_chain
from tensornetworks_tpu.ops import SteinOperator as JSteinOperator
from tensornetworks_tpu.ops import kron as jkron
from tensornetworks_tpu.ops import score_table as j_score_table
from tensornetworks_tpu.ops import stein as jstein
from tensornetworks_tpu.ops.pallas.circuit2d import make_pallas_circuit2d_probs
from tensornetworks_tpu.sim import ansatz_probs as j_ansatz_probs
from tensornetworks_tpu.sim import structured as jst
from tensornetworks_tpu_torch.core import get_random_chain_network as t_chain
from tensornetworks_tpu_torch.engines import common
from tensornetworks_tpu_torch.models import QuantumBornMachine
from tensornetworks_tpu_torch.ops import kron as tkron
from tensornetworks_tpu_torch.ops import stein as tstein
from tensornetworks_tpu_torch.ops.kernels import _lib
from tensornetworks_tpu_torch.ops.kernels import circuit2d as kc
from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg
from tensornetworks_tpu_torch.ops.kernels import precision as kp
from tensornetworks_tpu_torch.sim.ansatz import num_ansatz_params
from tensornetworks_tpu_torch.sim.gates import rotation_operators

F64 = torch.float64
HE, BN = "hardware_efficient", "bn_structured"
LIMITS = {"high": 1e-4, "default": 5e-2}


@pytest.fixture
def kernel_precision():
    """Set the kernel precision for one test; restored after it."""
    old = kp._kernel_precision()
    yield kp.set_kernel_precision
    kp.set_kernel_precision(old)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ------------------------------------------------------------ bf16 rounding


def _bf16_values():
    """Random, tiny (subnormal), huge and tie float32 values."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**16, size=4096, dtype=np.uint32) << 16
    ties = (bits | 0x8000).view(np.float32)        # exactly halfway
    near = np.concatenate([(bits | 0x7FFF).view(np.float32), (bits | 0x8001).view(np.float32)])
    return np.concatenate([
        rng.normal(size=4096).astype(np.float32),
        (rng.normal(size=1024) * 1e-40).astype(np.float32),
        (rng.normal(size=1024) * 1e37).astype(np.float32),
        ties[np.isfinite(ties)], near[np.isfinite(near)], np.float32([0.0, -0.0, 1.0, -1.0]),
    ])


def _jax_bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def test_round_bf16_is_jax_cast():
    x = _bf16_values()
    got = kp.round_bf16(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _jax_bf16(x).view(np.uint32))
    # A float64 operand is rounded as the FP32 value the kernels receive.
    x64 = np.random.default_rng(1).normal(size=512)
    np.testing.assert_array_equal(kp.round_bf16(torch.as_tensor(x64)).numpy(),
                                  _jax_bf16(x64.astype(np.float32)).astype(np.float64))


def test_split_bf16_is_jax_cast_of_the_remainder():
    x = _bf16_values()
    hi, lo = kp.split_bf16(torch.as_tensor(x))
    want_hi = _jax_bf16(x)
    want_lo = _jax_bf16((x - want_hi).astype(np.float32))
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), want_hi.view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), want_lo.view(np.uint32))
    # hi + lo keeps about 16 bits: within 2^-16 of x where x is normal (and
    # hi did not round up to infinity).
    normal = (np.abs(x) > 1e-30) & np.isfinite(hi.numpy())
    err = np.abs(hi.numpy()[normal] + lo.numpy()[normal] - x[normal]) / np.abs(x[normal])
    assert err.max() <= 2.0**-16


# ----------------------------------------------------------------- the knob


def test_kernel_precision_names(kernel_precision):
    for name, want in (("HIGH", "high"), ("Default", "default"), ("highest", "highest")):
        kernel_precision(name)
        assert kp._kernel_precision() == want
        assert kc.CircuitPlan(3, 1, HE).precision == want
        assert kg.GridPlan(3, 1, HE).precision == want
    with pytest.raises(KeyError):
        kernel_precision("bf16")
    with pytest.raises(KeyError):
        kc.CircuitPlan(3, 1, HE, precision="fp8")
    assert kp.CODES == {"highest": 0, "high": 1, "default": 2}


def test_kernel_precision_env_is_read_at_import():
    code = ("from tensornetworks_tpu_torch.ops.kernels import precision, circuit2d; "
            "print(precision._kernel_precision(), circuit2d.CircuitPlan(4, 1, 'basic').precision)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, TNTPU_KERNEL_PRECISION="High", PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["high", "high"]


def test_machine_keeps_the_precision_it_was_built_with(kernel_precision):
    n, L = 5, 2
    th = torch.as_tensor(np.random.default_rng(5).uniform(0, 2 * np.pi, 3 * L * n))
    kernel_precision("highest")
    qbm = QuantumBornMachine(n, L, HE, backend="circuit2d", dtype=F64, device="cpu")
    before = qbm.probs(th)
    kernel_precision("default")
    np.testing.assert_array_equal(qbm.probs(th).numpy(), before.numpy())
    low = QuantumBornMachine(n, L, HE, backend="circuit2d", dtype=F64, device="cpu").probs(th)
    assert _rel(low, before) > 1e-4  # a machine built now takes the new precision


# ------------------------------------------------- highest_matmul_precision


@pytest.mark.parametrize("name,tf32", [("default", True), ("HIGH", False), ("highest", False)])
@pytest.mark.parametrize("before", [False, True])
def test_matmul_context_sets_and_restores_tf32(monkeypatch, name, tf32, before):
    monkeypatch.setenv("TNTPU_MATMUL_PRECISION", name)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", before)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", before)
    with common.highest_matmul_precision():
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.backends.cuda.matmul.allow_tf32 is before
    assert torch.backends.cudnn.allow_tf32 is before


def test_matmul_context_default_is_fp32(monkeypatch):
    monkeypatch.delenv("TNTPU_MATMUL_PRECISION", raising=False)
    assert torch.backends.cuda.matmul.allow_tf32 is False  # the package's import state
    with common.highest_matmul_precision():
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    monkeypatch.setenv("TNTPU_MATMUL_PRECISION", "tf32")
    with pytest.raises(KeyError):
        with common.highest_matmul_precision():
            pass


def _sprinkler_quantum():
    from tensornetworks_tpu_torch.core import get_sprinkler_network
    from tensornetworks_tpu_torch.engines import QuantumKSDVariationalInference

    bn = get_sprinkler_network()
    eng = QuantumKSDVariationalInference(bn, ["C", "S", "R"], ["W"], qbm_num_latent_vars=3,
                                         qbm_ansatz_layers=1, seed=0, device="cpu")
    return lambda: eng.train({"W": 1}, num_epochs=2, lr_born_machine=1e-2, verbose=False)


def _sprinkler_classical():
    from tensornetworks_tpu_torch.core import get_sprinkler_network
    from tensornetworks_tpu_torch.engines import KSDVariationalInference

    eng = KSDVariationalInference(get_sprinkler_network(), ["C", "S", "R"], ["W"],
                                  {"conditioning_dim": 0}, device="cpu")
    return lambda: eng.train({"W": 1}, num_epochs=2, lr_born_machine=1e-2, verbose=False)


def _sprinkler_adversarial():
    from tensornetworks_tpu_torch.core import get_sprinkler_network
    from tensornetworks_tpu_torch.engines import AdversarialVariationalInference

    eng = AdversarialVariationalInference(get_sprinkler_network(), ["C", "S", "R"], ["W"],
                                          device="cpu")
    return lambda: eng.train({"W": 1}, num_epochs=2, batch_size=8, lr_born_machine=1e-2,
                             lr_classifier=1e-2, verbose=False)


def _sampled():
    from tensornetworks_tpu_torch.engines import SampledKSDVariationalInference

    bn = t_chain(6, seed=0)
    eng = SampledKSDVariationalInference(bn, [f"V{i}" for i in range(5)], ["V5"],
                                         qbm_ansatz_layers=1, num_samples=16, seed=0,
                                         device="cpu")
    return lambda: eng.train({"V5": 1}, num_epochs=2, lr_born_machine=1e-2, verbose=False)


def _amortized():
    from tensornetworks_tpu_torch.engines import AmortizedKSD

    bn = t_chain(6, seed=3, num_observed=3)
    observed = [f"V{i}" for i in range(3, 6)]
    eng = AmortizedKSD(bn, [f"V{i}" for i in range(3)], observed,
                       born_machine_config={"use_logits": True, "dropout_rate": 0.0},
                       device="cpu")
    obs = [dict(zip(observed, x)) for x in ((0, 0, 1), (1, 0, 1))]
    return lambda: eng.train(obs, num_epochs=2, lr=1e-2, verbose=False)


def _multi_seed():
    from tensornetworks_tpu_torch.engines.amortized import train_multi_seed

    bn = t_chain(5, seed=0)
    return lambda: train_multi_seed(bn, [f"V{i}" for i in range(4)], {"V4": 1}, num_seeds=2,
                                    ansatz_layers=1, num_epochs=2, device="cpu")


def _distill():
    from tensornetworks_tpu_torch.engines import distill

    qbm = QuantumBornMachine(3, 1, HE, dtype=torch.float32, device="cpu")
    target = np.full(8, 1 / 8)
    return lambda: (distill.fit_born_machine(qbm, target, num_epochs=2),
                    distill.fit_conditioned_born_machine(
                        QuantumBornMachine(3, 1, HE, dtype=torch.float32, device="cpu",
                                           conditioning_dim=1),
                        np.stack([target, target]), np.array([[0.0], [1.0]]), num_epochs=2))


ENGINE_RUNS = {"ksd.QuantumKSDVariationalInference": _sprinkler_quantum,
               "ksd.KSDVariationalInference": _sprinkler_classical,
               "advi.AdversarialVariationalInference": _sprinkler_adversarial,
               "sampled.SampledKSDVariationalInference": _sampled,
               "amortized.AmortizedKSD": _amortized,
               "amortized.train_multi_seed": _multi_seed,
               "distill.fit_born_machine": _distill}


@pytest.mark.parametrize("case", sorted(ENGINE_RUNS))
def test_each_engine_trains_inside_the_matmul_context(monkeypatch, case):
    """A probe in place of the engines' ``make_optimizer`` (and of the Born
    machine's probabilities, which ``posterior_for`` reads) records the TF32
    flag while the engine runs; ``TNTPU_MATMUL_PRECISION=default`` sets it."""
    from tensornetworks_tpu_torch import engines

    run = ENGINE_RUNS[case]()
    seen = []
    module = getattr(engines, case.split(".")[0])
    make = module.make_optimizer

    def probe(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return make(*args, **kwargs)

    monkeypatch.setattr(module, "make_optimizer", probe)
    monkeypatch.setenv("TNTPU_MATMUL_PRECISION", "default")
    run()
    assert seen and all(seen)
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_distributed_trains_and_posterior_are_wrapped():
    """The distributed engines' ``train`` (run in each rank's process) and
    the amortized ``posterior_for`` carry the context as a decorator."""
    from tensornetworks_tpu_torch.engines import amortized, distributed, distributed_sampled

    context = common.highest_matmul_precision.__wrapped__  # the generator function
    for fn in (distributed.DistributedQuantumKSDVariationalInference.train,
               distributed_sampled.DistributedSampledKSDVariationalInference.train,
               amortized.AmortizedKSD.posterior_for):
        cells = [c.cell_contents for c in fn.__closure__ or ()]
        assert any(getattr(c, "func", None) is context for c in cells), fn


# -------------------------------------------- the circuit kernels' plain versions


def _seed_forward_plain(mr_re, mr_im, mc_re, mc_im, plan):
    """circuit2d_forward_plain as it was before the precision knob."""
    R, C, dt = plan.R, plan.C, mr_re.dtype
    dst, sign = plan.tables("cpu")
    if plan.has_wall:
        xr = torch.full((R, C), 2.0 ** (-0.5 * plan.n), dtype=dt)
    else:
        xr = torch.zeros((R, C), dtype=dt)
        xr[0, 0] = 1.0
    xi = torch.zeros((R, C), dtype=dt)
    for layer in range(plan.layers):
        tr, ti = kc._cmm(mr_re[layer], mr_im[layer], xr, xi)
        zr, zi = kc._cmm(tr, ti, mc_re[layer].T, mc_im[layer].T)
        d, s = kc.layer_map(dst, sign, layer)
        s = s.to(dt)
        xr = torch.empty_like(zr).reshape(-1).index_put_((d,), s * zr.reshape(-1)).reshape(R, C)
        xi = torch.empty_like(zi).reshape(-1).index_put_((d,), s * zi.reshape(-1)).reshape(R, C)
    return xr * xr + xi * xi, xr, xi


def _seed_backward_plain(mr_re, mr_im, mc_re, mc_im, xr, xi, g, plan):
    """circuit2d_backward_plain as it was before the precision knob."""
    R, C, cmm = plan.R, plan.C, kc._cmm
    dst, sign = plan.tables("cpu")
    dmr_re, dmr_im = torch.empty_like(mr_re), torch.empty_like(mr_im)
    dmc_re, dmc_im = torch.empty_like(mc_re), torch.empty_like(mc_im)
    planes = torch.stack([xr, xi, 2.0 * g * xr, 2.0 * g * xi])
    for layer in range(plan.layers - 1, -1, -1):
        d, s = kc.layer_map(dst, sign, layer)
        planes = (s.to(planes.dtype) * planes.reshape(4, -1)[:, d]).reshape(4, R, C)
        ar, ai, lr_, li = planes
        m_r, m_i, c_r, c_i = mr_re[layer], mr_im[layer], mc_re[layer], mc_im[layer]
        xb_r, xb_i = cmm(ar, ai, c_r, -c_i)
        lb_r, lb_i = cmm(lr_, li, c_r, -c_i)
        dmc_re[layer], dmc_im[layer] = cmm(lr_.T, li.T, xb_r, -xb_i)
        xa_r, xa_i = cmm(m_r.T, -m_i.T, xb_r, xb_i)
        la_r, la_i = cmm(m_r.T, -m_i.T, lb_r, lb_i)
        dmr_re[layer], dmr_im[layer] = cmm(lb_r, lb_i, xa_r.T, -xa_i.T)
        planes = torch.stack([xa_r, xa_i, la_r, la_i])
    return dmr_re, dmr_im, dmc_re, dmc_im


def _edges(n):
    return jst.latent_edges(j_chain(n + 1, seed=1), [f"V{i}" for i in range(n)])


def _jax_reference(n, L, ansatz, edges, th, v):
    """The JAX package's float64 probabilities and gradient of probs·v."""
    if ansatz == BN:
        fn = jst.make_structured_probs_fn(n, L, edges, dtype=jnp.complex128)
    else:
        def fn(p):
            return j_ansatz_probs(p, n, L, ansatz, dtype=jnp.complex128)
    p = np.asarray(fn(jnp.asarray(th)))
    g = np.asarray(jax.grad(lambda q: fn(q) @ jnp.asarray(v))(jnp.asarray(th)))
    return p, g


def _port(n, L, ansatz, edges, th, v, backend, precision, kernel_precision):
    kernel_precision(precision)
    qbm = QuantumBornMachine(n, L, ansatz, backend=backend, dtype=F64, device="cpu",
                             edges=edges)
    before = dict(_lib.LAUNCHES)
    p = torch.as_tensor(th).requires_grad_(True)
    q = qbm.probs(p)
    (q @ torch.as_tensor(v)).backward()
    assert _lib.LAUNCHES == before  # CPU tensors run the plain versions
    return q.detach().numpy(), p.grad.numpy()


CIRCUIT_CASES = [(n, L, a) for n in range(2, 8) for L in (1, 2) for a in (HE, BN)]


@pytest.mark.parametrize("n,L,ansatz", CIRCUIT_CASES)
def test_circuit_plain_precisions_match_jax_float64(n, L, ansatz, kernel_precision):
    edges = _edges(n) if ansatz == BN else None
    th = np.random.default_rng(n + 10 * L).uniform(0, 2 * np.pi,
                                                  num_ansatz_params(n, L, ansatz))
    v = np.random.default_rng(n).normal(size=2**n)
    p_j, g_j = _jax_reference(n, L, ansatz, edges, th, v)
    err = {}
    for prec in ("high", "default"):
        p_t, g_t = _port(n, L, ansatz, edges, th, v, "circuit2d", prec, kernel_precision)
        err[prec] = max(_rel(p_t, p_j), _rel(g_t, g_j))
        assert err[prec] <= LIMITS[prec], (prec, err[prec])
    assert err["default"] > err["high"]


@pytest.mark.parametrize("n,L,ansatz", [(3, 1, HE), (6, 2, HE), (7, 2, BN)])
def test_circuit_plain_highest_is_the_fp32_plain_version(n, L, ansatz):
    edges = _edges(n) if ansatz == BN else None
    plan = kc.CircuitPlan(n, L, ansatz, edges, precision="highest")
    th = torch.as_tensor(np.random.default_rng(n).uniform(0, 2 * np.pi, 3 * L * n),
                         dtype=torch.float32)
    Mr, Mc = rotation_operators(th, n, L, plan.per_qubit)
    planes = [t.contiguous() for t in (Mr.real, Mr.imag, Mc.real, Mc.imag)]
    got = kc.circuit2d_forward_plain(*planes, plan)
    want = _seed_forward_plain(*planes, plan)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    g = torch.as_tensor(np.random.default_rng(1).normal(size=(plan.R, plan.C)),
                        dtype=torch.float32)
    got = kc.circuit2d_backward_plain(*planes, want[1], want[2], g, plan)
    for a, b in zip(got, _seed_backward_plain(*planes, want[1], want[2], g, plan)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("n,L,ansatz", [(4, 2, HE), (5, 2, BN), (7, 3, HE)])
def test_phased_plain_versions_follow_the_precision(n, L, ansatz, precision):
    """The persistent kernels' phase mirrors at a precision agree with the
    plain versions at it (both emulate the same passes)."""
    edges = _edges(n) if ansatz == BN else None
    plan = kc.CircuitPlan(n, L, ansatz, edges, precision=precision)
    th = torch.as_tensor(np.random.default_rng(n).uniform(0, 2 * np.pi, 3 * L * n))
    Mr, Mc = rotation_operators(th, n, L, plan.per_qubit)
    planes = [t.contiguous() for t in (Mr.real, Mr.imag, Mc.real, Mc.imag)]
    want = kc.circuit2d_forward_plain(*planes, plan)
    got = kc.circuit2d_forward_phased_plain(*planes, plan)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12, rtol=0)
    g = torch.as_tensor(np.random.default_rng(2).normal(size=(plan.R, plan.C)))
    want = kc.circuit2d_backward_plain(*planes, want[1], want[2], g, plan)
    got = kc.circuit2d_backward_phased_plain(*planes, got[1], got[2], g, plan)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-11, rtol=0)


def test_no_wall_first_product_follows_the_precision():
    """Without the Hadamard wall the first phase is column 0 of Mr[0]."""
    n, L = 5, 2
    th = torch.as_tensor(np.random.default_rng(3).uniform(0, 2 * np.pi, 2 * L * n))
    for prec in ("high", "default"):
        plan = kc.CircuitPlan(n, L, "basic", precision=prec)
        Mr, Mc = rotation_operators(th, n, L, plan.per_qubit)
        planes = [t.contiguous() for t in (Mr.real, Mr.imag, Mc.real, Mc.imag)]
        for a, b in zip(kc.circuit2d_forward_phased_plain(*planes, plan),
                        kc.circuit2d_forward_plain(*planes, plan)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12, rtol=0)


def test_high_matches_the_pallas_kernel_in_interpret_mode(kernel_precision):
    """n=4, HE L=2: the JAX package's TPU kernel (FP32, interpret mode)
    against the port's plain version under ``high`` in FP32."""
    n, L = 4, 2
    th = np.random.default_rng(4).uniform(0, 2 * np.pi, 3 * L * n)
    v = np.random.default_rng(5).normal(size=2**n)
    fn = make_pallas_circuit2d_probs(n, L, HE, interpret=True)
    th32, v32 = jnp.asarray(th, jnp.float32), jnp.asarray(v, jnp.float32)
    p_j = np.asarray(fn(th32))
    g_j = np.asarray(jax.grad(lambda p: fn(p) @ v32)(th32))
    kernel_precision("high")
    qbm = QuantumBornMachine(n, L, HE, backend="circuit2d", dtype=torch.float32, device="cpu")
    p = torch.as_tensor(th, dtype=torch.float32).requires_grad_(True)
    q = qbm.probs(p)
    (q @ torch.as_tensor(v, dtype=torch.float32)).backward()
    assert _rel(q.detach().numpy(), p_j) <= LIMITS["high"]
    assert _rel(p.grad.numpy(), g_j) <= LIMITS["high"]


@pytest.mark.parametrize("n,L,ansatz", [(5, 2, HE), (6, 2, HE), (7, 3, HE), (5, 2, BN)])
def test_grid_plain_precisions_match_jax_float64(n, L, ansatz, kernel_precision):
    """The grid kernels' plain versions (the TPU grid kernel's W-form algebra
    for HE, the index maps for bn_structured) at the smallest sizes of the
    grid tests."""
    edges = _edges(n) if ansatz == BN else None
    th = np.random.default_rng(n + L).uniform(0, 2 * np.pi, num_ansatz_params(n, L, ansatz))
    v = np.random.default_rng(n).normal(size=2**n)
    p_j, g_j = _jax_reference(n, L, ansatz, edges, th, v)
    err = {}
    for prec in ("high", "default"):
        p_t, g_t = _port(n, L, ansatz, edges, th, v, "circuit2d_grid", prec, kernel_precision)
        err[prec] = max(_rel(p_t, p_j), _rel(g_t, g_j))
        assert err[prec] <= LIMITS[prec], (prec, err[prec])
    assert err["default"] > err["high"]
    p_t, g_t = _port(n, L, ansatz, edges, th, v, "circuit2d_grid", "highest", kernel_precision)
    np.testing.assert_allclose(p_t, p_j, atol=1e-12, rtol=0)
    np.testing.assert_allclose(g_t, g_j, atol=1e-10, rtol=0)


# ----------------------------------------------------- compute_dtype, use_pallas


def _score(n, seed=2):
    bn = j_chain(n + 1, seed=seed)
    t = bn.conditional_joint_table([f"V{i}" for i in range(n)], {f"V{n}": 1})
    return np.asarray(j_score_table(t))


@pytest.mark.parametrize("cols", [None, 1, 5])
def test_kron_matvec_compute_dtype_matches_jax(cols):
    n = 9
    a = 0.3
    A = np.array([[1.0, a], [a, 1.0]])
    shape = (2**n,) if cols is None else (2**n, cols)
    v = np.random.default_rng(cols or 0).normal(size=shape).astype(np.float32)
    want = np.asarray(jkron.kron_matvec(jnp.asarray(v), A, n, group=4,
                                        compute_dtype=jnp.bfloat16))
    got = tkron.kron_matvec(torch.as_tensor(v), A, n, group=4, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and got.shape == v.shape
    assert _rel(got.numpy(), want) < 2e-2
    exact = tkron.kron_matvec(torch.as_tensor(v, dtype=F64), A, n, group=4).numpy()
    assert 1e-5 < _rel(got.numpy(), exact) < 2e-2  # bf16 passes: off FP32, within bound


def test_kron_matvec_rows_on_bf16_matches_jax():
    n, a = 10, 0.4
    A = np.array([[1.0, a], [a, 1.0]])
    v = np.random.default_rng(3).normal(size=(4, 2**n)).astype(np.float32)
    want = np.asarray(jkron.kron_matvec_rows(jnp.asarray(v, jnp.bfloat16), A, n, group=3)
                      .astype(jnp.float32))
    got = tkron.kron_matvec_rows(torch.as_tensor(v).to(torch.bfloat16), A, n, group=3)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) < 2e-2


@pytest.mark.parametrize("n", [8, 14])
def test_stein_operator_compute_dtype_matches_jax(n):
    """The 3n+1 form with bf16 passes (n=8: the grouped matvec; n=14: the
    two-sided split, which ignores compute_dtype in both packages): matvec
    and the quadform's gradient against the JAX operator's."""
    S = _score(n)
    q = np.random.default_rng(1).random(2**n).astype(np.float32)
    jop = JSteinOperator(S, n, dense=False, compute_dtype=jnp.bfloat16, use_pallas=True)
    top = tstein.SteinOperator(S, n, dense=False, device="cpu", compute_dtype=torch.bfloat16,
                               use_pallas=True)
    assert top.gcorr is None
    qj, qt = jnp.asarray(q), torch.as_tensor(q)
    assert _rel(top.matvec(qt).numpy(), np.asarray(jop.matvec(qj))) < 2e-2
    gj = np.asarray(jax.grad(jop.quadform)(qj))
    qt.requires_grad_(True)
    top.quadform(qt).backward()
    assert _rel(qt.grad.numpy(), gj) < 2e-2
    # compute_dtype does not reach the gcorr tables, as in JAX
    g32 = tstein.SteinOperator(S, n, dense=False, device="cpu")
    gbf = tstein.SteinOperator(S, n, dense=False, device="cpu", compute_dtype=torch.bfloat16)
    assert torch.equal(g32.matvec(torch.as_tensor(q)), gbf.matvec(torch.as_tensor(q)))


def test_stein_matvec_compute_dtype_rows_route_matches_jax():
    """n=18: the grouped row layout on bf16 columns, as JAX routes it."""
    n = 18
    S = _score(n)
    q = np.random.default_rng(4).random(2**n)
    q = (q / q.sum()).astype(np.float32)
    B = np.asarray(jstein.all_bitstrings(n), dtype=np.float32)
    want = np.asarray(jstein.stein_matvec(jnp.asarray(q), jnp.asarray(S, jnp.float32),
                                          jnp.asarray(B), n, compute_dtype=jnp.bfloat16))
    got = tstein.stein_matvec(torch.as_tensor(q), torch.as_tensor(S, dtype=torch.float32),
                              torch.as_tensor(B), n, compute_dtype=torch.bfloat16)
    assert _rel(got.numpy(), want) < 2e-2


@pytest.mark.parametrize("n", [8, 13])
def test_stein_operator_use_pallas_quadform_matches_jax_float64(n):
    """``use_pallas``: the 3n+1 form, gcorr off, its columns through the
    stein2d kernel's plain version on the CPU; the JAX operator's quadform
    on the same score in float64."""
    S = _score(n, seed=3)
    q = np.random.default_rng(n).random(2**n)
    jop = JSteinOperator(S, n, dtype=jnp.float64, dense=False, use_pallas=True)
    top = tstein.SteinOperator(S, n, dtype=F64, dense=False, device="cpu", use_pallas=True)
    before = dict(_lib.LAUNCHES)
    got = float(top.quadform(torch.as_tensor(q)))
    assert _lib.LAUNCHES == before
    assert top.gcorr is None
    want = float(jop.quadform(jnp.asarray(q)))
    assert abs(got - want) <= 1e-10 * abs(want)
    # and the gcorr operator's quadform, the production form
    assert abs(float(tstein.SteinOperator(S, n, dtype=F64, dense=False, device="cpu")
                     .quadform(torch.as_tensor(q))) - want) <= 1e-10 * abs(want)


@pytest.mark.parametrize("n", [13, 18])
def test_stein_kernels_stay_fp32_under_every_precision(n, kernel_precision):
    """Kernels 3-4 take no precision: the Stein operator's quadform is the
    same under every kernel precision."""
    S = _score(n)
    q = torch.as_tensor(np.random.default_rng(0).random(2**n), dtype=torch.float32)
    out = []
    for prec in ("highest", "high", "default"):
        kernel_precision(prec)
        out.append(tstein.SteinOperator(S, n, dense=False, device="cpu").matvec(q))
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])


def test_bench_precision_sets_and_restores_both_knobs(monkeypatch, kernel_precision):
    """``runners/bench_precision.py``: ``both`` sets the two knobs to one
    name, ``kernel`` the kernel knob alone; both are restored after."""
    from tensornetworks_tpu_torch.runners import bench_precision as bp

    seen = []

    def probe(device):
        seen.append((kp._kernel_precision(), os.environ.get("TNTPU_MATMUL_PRECISION")))
        return {}

    monkeypatch.setattr(bp, "CONFIGS", {"probe": probe})
    kernel_precision("highest")
    monkeypatch.setenv("TNTPU_MATMUL_PRECISION", "highest")
    rows = bp.run([("HIGH", "both"), ("default", "kernel")], ["probe"], device="cpu",
                  verbose=False)
    assert seen == [("high", "high"), ("default", None)]
    assert [(r["precision"], r["knobs"]) for r in rows] == [("high", "both"), ("default", "kernel")]
    assert kp._kernel_precision() == "highest"
    assert os.environ["TNTPU_MATMUL_PRECISION"] == "highest"
    with pytest.raises(ValueError):
        bp.run_setting("high", "matmul", ["probe"], device="cpu")
