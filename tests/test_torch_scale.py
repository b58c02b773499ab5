"""The port's large-n exact KSD path against the JAX package: the stein2d
grid kernel's plain version against the TPU grid kernel in interpret mode,
the n=18 Stein operator against JAX's gcorr matvec, a 2-epoch n=18 engine
run (grid circuit, grid Stein apply) against the JAX engine, and the scale
runner (``make_scale_problem``, ``lr_phases``, reporting).

Float64 on the CPU throughout, except where JAX runs a float32 Pallas kernel
in interpret mode (1e-5 relative to the result's scale, the float32 round-off
of 2^n-long sums). Otherwise the tolerance is summation order: 1e-10
relative on the operator and 1e-9 relative on the engine's histories. The
runner's ``lr_phases`` test holds the runner against the same engine calls
made by hand, both in the runner's float32, for exact equality. The CUDA
kernels themselves run only on the card, in chip_smoke.py. Measured
time of this file on the CPU: about 25 s in one process, most of it the two
n=18 cases."""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensornetworks_tpu.core import all_bitstrings as j_all_bitstrings
from tensornetworks_tpu.engines.ksd import QuantumKSDVariationalInference as JEngine
from tensornetworks_tpu.models import QuantumBornMachine as JQBM
from tensornetworks_tpu.ops import stein as jstein
from tensornetworks_tpu.ops.pallas.stein2d import make_pallas_stein2d_matvec_grid
from tensornetworks_tpu.runners import reporting as jreporting
from tensornetworks_tpu.runners.scale import make_scale_problem as j_make_scale_problem
from tensornetworks_tpu_torch.engines import QuantumKSDVariationalInference
from tensornetworks_tpu_torch.interop import quantum_engine_with_params
from tensornetworks_tpu_torch.ops import stein as tstein
from tensornetworks_tpu_torch.ops.hamming import decay_factor, resolve_length_scale
from tensornetworks_tpu_torch.ops.kernels import _lib
from tensornetworks_tpu_torch.ops.kernels import stein2d as tk
from tensornetworks_tpu_torch.runners import reporting as treporting
from tensornetworks_tpu_torch.runners import scale as tscale

F64 = torch.float64


def _problem(n):
    bn, latent, obs = tscale.make_scale_problem(n, seed=0)
    return bn, latent, obs, tstein.score_table(bn.conditional_joint_table(latent, obs))


def _q(n, seed=1):
    q = np.random.default_rng(seed).random(2**n)
    return q / q.sum()


def _close(a, b, rel):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=rel * np.abs(b).max())


@pytest.mark.parametrize("n", [6, 8])
def test_stein2d_apply_grid_matches_pallas_grid_kernel(n):
    """The operator's column build and recombination around the grid apply
    (its plain version on CPU tensors) against the TPU grid kernel's matvec."""
    _, _, _, S = _problem(n)
    q, ls = _q(n), resolve_length_scale("auto", n)
    mv = make_pallas_stein2d_matvec_grid(n, ls, interpret=True)
    y_j = mv(jnp.asarray(q), jnp.asarray(S), jnp.asarray(j_all_bitstrings(n).astype(np.float64)))
    Vw, W = (torch.as_tensor(t) for t in tstein.stein_weight_tables(S, n, ls))
    rb = (n + 1) // 2
    V = (Vw * torch.as_tensor(q)).reshape(-1, 1 << rb, 1 << (n - rb))
    before = dict(_lib.LAUNCHES)
    Y = tk.stein2d_apply_grid(decay_factor(n, ls), V)
    assert _lib.LAUNCHES == before  # CPU tensors never reach a kernel
    _close((W * Y.reshape(W.shape)).sum(dim=0), y_j, rel=1e-5)


def test_grid_chunk_keeps_the_intermediate_in_l2():
    assert tk.grid_chunk(1024, 1024, 61) == 6  # n=20: 6 blocks of 4 MB
    assert tk.grid_chunk(512, 512, 55) == 24  # n=18
    assert tk.grid_chunk(2048, 2048, 67) == 1  # n=22: one 16 MB block
    assert tk.grid_chunk(64, 32, 19) == 19  # small n: one chunk


def test_operator_n18_matches_jax_gcorr_matvec():
    """From n=18 the operator runs the grid apply; JAX's production matvec
    there is the gcorr n+1-column form with the ``corr="matmul"`` step."""
    n = 18
    _, _, _, S = _problem(n)
    q, ls = _q(n), resolve_length_scale("auto", n)
    op_t = tstein.SteinOperator(S, n, ls, dtype=F64, device="cpu")
    assert op_t._grid and not hasattr(op_t, "_Ar")  # the butterfly takes a alone
    assert not tstein.SteinOperator(S[:2**13, :13], 13, device="cpu")._grid
    op_j = jstein.SteinOperator(S, n, ls, dtype=jnp.float64)
    assert op_j._gcorr_corr == "matmul"
    _close(op_t.matvec(torch.as_tensor(q)), op_j.matvec(jnp.asarray(q)), rel=1e-10)


def test_engine_n18_two_epochs_match_jax():
    """Two epochs from a shared θ: the port's auto backend is the grid
    circuit, JAX's the blocked executor (complex128); both run the Stein
    operator in float64 at the ``auto`` length scale."""
    n, L = 18, 1
    bn, latent, obs, _ = _problem(n)
    theta = 0.1 * np.random.default_rng(18).normal(size=3 * L * n)
    jbn, _, _ = j_make_scale_problem(n, seed=0)
    jeng = JEngine(jbn, latent, list(obs), qbm_num_latent_vars=n, qbm_ansatz_layers=L,
                   dtype=jnp.float64, base_kernel_length_scale="auto")
    jeng.born_machine = JQBM(n, ansatz_layers=L, dtype=jnp.complex128)
    jeng.params = jnp.asarray(theta)
    teng = quantum_engine_with_params(theta, bn, latent, list(obs), qbm_ansatz_layers=L,
                                      dtype=F64, device="cpu", base_kernel_length_scale="auto")
    assert teng.born_machine.backend == "circuit2d_grid"
    post = bn.posterior_vector(latent, obs)
    kw = dict(num_epochs=2, lr_born_machine=0.05, verbose=False, true_posterior_for_tvd=post)
    hj, ht = jeng.train(obs, **kw), teng.train(obs, **kw)
    for key in ("loss_ksd", "tvd", "grad_norm"):
        np.testing.assert_allclose(ht[key], hj[key], rtol=1e-9, err_msg=key)
    assert teng.best_tvd_ == pytest.approx(jeng.best_tvd_, rel=1e-9)


@pytest.mark.parametrize("n", [4, 9])
def test_make_scale_problem_matches_jax(n):
    bn, latent, obs = tscale.make_scale_problem(n, seed=3)
    jbn, jlatent, jobs = j_make_scale_problem(n, seed=3)
    assert (latent, obs) == (jlatent, jobs)
    np.testing.assert_array_equal(bn.conditional_joint_table(latent, obs),
                                  jbn.conditional_joint_table(jlatent, jobs))
    np.testing.assert_array_equal(bn.posterior_vector(latent, obs),
                                  jbn.posterior_vector(jlatent, jobs))


def test_run_scale_experiment_lr_phases_equal_phases_by_hand():
    """Two phases, the second with its own length scale, equal the same
    engine trained phase by phase, with the across-phase best restored."""
    n, L, phases = 6, 2, [(8, 0.05), (6, 0.01, 0.5)]
    out = tscale.run_scale_experiment(num_qubits=n, layers=L, lr_phases=phases, seed=2,
                                      verbose=False, device="cpu")
    bn, latent, obs = tscale.make_scale_problem(n, seed=2)
    post = bn.posterior_vector(latent, obs)
    eng = QuantumKSDVariationalInference(
        bn, latent, list(obs), qbm_num_latent_vars=n, qbm_ansatz_layers=L, seed=2,
        base_kernel_length_scale="auto", device="cpu")
    best = []
    for epochs, lr, *ls in phases:
        if ls:
            eng.base_kernel_length_scale = resolve_length_scale(ls[0], n)
        hist = eng.train(obs, num_epochs=epochs, lr_born_machine=lr, verbose=False,
                         true_posterior_for_tvd=post, gradient_clip_norm=10.0)
        best.append((eng.best_tvd_, eng.best_params_))
    model = out["model"]
    assert model.base_kernel_length_scale == 0.5
    for key in ("loss_ksd", "tvd", "grad_norm"):
        assert out["history"][key] == hist[key], key
    best_tvd, best_params = min(best, key=lambda b: b[0])
    assert model.best_tvd_ == best_tvd
    assert torch.equal(model.params, best_params)


@pytest.mark.parametrize("kwargs", [dict(resume_state_path="r"), dict(checkpoint_path="c")])
def test_run_scale_experiment_names_what_is_not_ported(kwargs):
    """Resume and checkpoint run on the ksd and adversarial objectives
    (tests/test_torch_resume.py); the sampled engine has neither hook."""
    with pytest.raises(ValueError, match="no resume or checkpoint hook"):
        tscale.run_scale_experiment(num_qubits=3, layers=1, num_epochs=1, device="cpu",
                                    objective="sampled-ksd", **kwargs)


def test_print_stability_stats_matches_jax():
    rng = np.random.default_rng(0)
    hist = {"tvd": list(rng.random(12)) + [float("nan")], "epochs_per_sec": 12.5,
            "train_seconds": 3.0, "epochs_per_sec_steady": 14.0}
    outs = []
    for fn in (treporting.print_stability_stats, jreporting.print_stability_stats):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(hist)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "steady 14.0" in outs[0]
