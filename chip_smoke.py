#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tensornetworks_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. Require a CUDA device; print the card's name and power limit.
2. Build the hand-written kernels from ``tensornetworks_tpu_torch/csrc``.
3. Hold each kernel against its plain torch version on the card at its
   path's shapes, with FP32 tolerances, and time kernel, plain version and
   (where one exists) a single PyTorch library call computing the same
   function: circuit2d and stein2d at 16 qubits (hardware_efficient, L=4),
   circuit2d_grid and stein2d_grid at 20 qubits, and both again, untimed,
   at other shapes (circuit2d at n=2 and 3, ragged tiles, n=15 and 17, odd
   with R != C, 17 the largest the persistent kernels take, and n=5 with
   the basic ansatz, which has no Hadamard wall; stein2d at n=3 and 8 on
   random columns, the sizes below the Kronecker path, at n=13, several
   columns to a thread block, n=14, one, and n=15 and 17, clusters of two
   and eight blocks; circuit2d_grid and stein2d_grid at n=18, the fewest
   tiles, and n=19, where R != C; circuit2d_grid at n=21, where the
   forward's scatter product takes the large GEMM loop with R != C). Both
   stein2d kernels are also held against a float64 evaluation. The large
   GEMM loop, both butterflies and both persistent circuit kernels must
   show no spills in the ptxas report; the registers of the redesigned
   kernels are printed on a line of their own.
   The bn_structured ansatz (the latent DAG's CNOTs on even layers, its
   CZs on odd ones: one index map per layer in the same kernels) is held
   against the plain version and against its float64 oracle
   (``sim.structured``: its own rotations, per-edge flips), probabilities
   and θ-gradients: at n=16 and n=20, L=8, timed; untimed at n=17, 18 and
   19, at n=5 with high→low and repeated edges, at n=19 with the DAG's
   edges reversed and one repeated, and with no edges at all.
4. Drive the main path: exact quantum KSD-VI on the 16-qubit workload of
   ``bench.py`` (random chain network of 17 variables, seed 0, V16=1
   observed) through ``QuantumKSDVariationalInference.train``.
5. Drive the large-n path: ``run_scale_experiment`` at 20 qubits
   (hardware_efficient, L=4, 60 epochs), which resolves to the grid kernels.
6. Drive bn16, the quality configuration of ``bench.py``'s quality path
   (bn_structured, L=8, length scale 0.0625) for 3000 epochs at lr 0.05:
   its best TVD must be at most 0.15; and bn20, ``run_scale_experiment`` at
   20 qubits with bn_structured, L=8, for 30 epochs.
   For each of 4-6 the launch counts are zeroed just before and read just
   after; every kernel of the path's set (main16's for bn16, scale20's for
   bn20) must have launched and no other kernel; the loss must be finite
   and falling with no skipped update, and the first epoch's loss must
   agree with a float64 plain evaluation.
7. Train the Sprinkler 3-qubit configuration for 1000 epochs through the
   circuit kernels; best TVD must be at most 0.01.
8. Classical KSD-VI (``KSDVariationalInference``), no quantum circuit:
   sprinkler_classical, the reference's primary runner as shipped
   (conditional MLP, dropout 0.1, early stopping), best TVD ≤ 0.25, and with
   a table ≤ 0.15, launching no kernel (n=3, dense Gram); classical16, a
   2^16 softmax table on the 16-qubit network for up to 3000 epochs,
   launching stein2d only, best TVD within 0.05 of the JAX package's on the
   same configuration; classical20, the same at 2^20 for 30 epochs,
   launching stein2d_grid only. Each trained path's epoch-0 KSD must agree
   with float64.
9. Adversarial VI (``AdversarialVariationalInference``):
   sprinkler_adversarial, the Sprinkler runner as shipped (1500 epochs),
   best TVD ≤ 0.08, launching no kernel; adversarial16,
   ``run_scale_experiment(16, L=8, objective="adversarial",
   ansatz="bn_structured")`` for 1000 epochs, launching the two circuit
   kernels only: every epoch's losses finite, the floored ``log p(x|z)``
   table finite, the best TVD below epoch 0's and within 0.1 of the JAX
   package's at the same depth and seed.
   For 8-9 too the launch counts are zeroed just before each path and read
   just after.
10. The gcorr Stein operator's recombination kernel (stein_gcorr), held
   against its plain version on the path's own P0/Q (the operator applied
   to the path's Born machine's initial q) at n = 13 and 14 untimed, and at
   16 (ℓ = 1 and ℓ = 1/16), 20, 22 and 24 timed; at 16 and 20 also against
   float64 on the same inputs. The KSD paths' stein2d kernels are timed on
   the operator's n+1 columns (one untimed 3n+1 check from
   ``stein_weight_tables`` keeps the TPU kernel's shape covered), and
   stein2d_grid at n = 22 and 24 and circuit2d_grid (bn_structured, L=8)
   at n = 24 against their plain versions.
11. exact22, the tempered target: ``run_scale_experiment(22, L=4,
   temper_betas=[0.5, 1.0])`` for 20 epochs in chunks of 10; the engine
   builds two operators, epoch 0's loss agrees with the β = 0.5 operator's
   in float64. exact24, the widest exact path:
   ``run_scale_experiment(24, L=8, ansatz="bn_structured", lr=0.05)`` for
   10 epochs in chunks of 5 with the TVD tracked (the JAX package's
   ``examples/exact_ksd_24_qubits.py`` cut from 3000 epochs); every loss
   finite, the last chunk's mean loss below the first's, epoch 0's loss
   against float64 (the Stein part from the gcorr plain version: the 3n+1
   oracle's float64 columns would take about 30 GB). Both launch exactly
   the grid circuit kernels, stein2d_grid and stein_gcorr.

Prints each phase's seconds, a ``{"kernels": [...]}`` line (each kernel
with the launch count of the path that runs it, and its launches on every
path that runs it), a ``{"bn_structured": [...]}`` line (the timed
bn_structured checks and each bn path's launches), a ``{"large_n": [...]}``
line (the timed checks at the wide shapes of step 10, with the exact paths'
launches) and, last, the ``{"ok": true, ...}`` line. Imports nothing of JAX
or of the JAX package.
"""

import functools
import json
import math
import statistics
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, and HBM3 bandwidth. The port runs FP32 FMA only (no TF32).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Device clock cycles of sleep queued ahead of each timed call (~0.1 ms at
# the H100's 1.98 GHz boost clock), see time_ms.
SLEEP_CYCLES_PER_CALL = 200_000

N, LAYERS, ANSATZ = 16, 4, "hardware_efficient"
N_MIN, N_RAGGED, N_ODD, N_MAX, N_NO_WALL = 2, 3, 15, 17, 5
N_STEIN = (13, 14, 15, 17)  # stein2d: several columns a block, one, clusters of 2 and 8
N_STEIN_RANDOM = (3, 8)     # stein2d below the Kronecker path (SteinOperator dense=False)
MAIN_EPOCHS = 300
N_GRID, N_GRID_ODD, N_GRID_MIN, N_GRID_WIDE = 20, 19, 18, 21
# The exact paths at 22 and 24 qubits: exact22 (hardware_efficient L=4, the
# tempered target), exact24 (examples/exact_ksd_24_qubits.py: bn_structured
# L=8, lr 0.05, chunks of 5, cut from 3000 epochs to 10).
N_EXACT22, N_EXACT24 = 22, 24
EXACT22_EPOCHS, EXACT22_CHUNK, EXACT22_BETAS = 20, 10, [0.5, 1.0]
EXACT24_EPOCHS, EXACT24_CHUNK = 10, 5
# Timed calls at n >= 22 take up to a second: fewer of them.
WIDE_REPS, WIDE_ROUNDS = 2, 3
SCALE_EPOCHS, SCALE_CHUNK = 60, 20
SPRINKLER_TVD_MAX = 0.01
# bn_structured: bench.py's quality configuration at 16 qubits, and the JAX
# package's 20-qubit structured run (examples/structured_ansatz_20_qubits.py).
BN = "bn_structured"
BN_LAYERS, BN_LENGTH_SCALE, BN_LR = 8, 0.0625, 0.05
BN16_EPOCHS, BN16_CHUNK, BN16_TVD_MAX = 3000, 500, 0.15
BN20_EPOCHS, BN20_CHUNK = 30, 10
# Classical KSD: the Sprinkler runner as shipped (conditional MLP, dropout
# 0.1; the JAX package reached 0.15201, RESULTS.md:75) and with a table (the
# bound of tests/test_engines.py:47); a 2^16 table on the 16-qubit network
# (ℓ = 1, lr 5e-3, clip 5, entropy 1e-3, patience 200), whose limit is the
# JAX package's best TVD for the same configuration in float32 on a CPU
# (0.38214 after 3000 epochs, no stop; scripts/jax_reference_tvd.py) + 0.05;
# the same at 2^20 for 30 epochs.
CLASSICAL_SPRINKLER_TVD_MAX, CLASSICAL_TABLE_TVD_MAX = 0.25, 0.15
CLASSICAL16_EPOCHS, CLASSICAL20_EPOCHS = 3000, 30
CLASSICAL16_JAX_TVD = 0.38214
CLASSICAL16_TVD_MAX = CLASSICAL16_JAX_TVD + 0.05
# Adversarial VI: the Sprinkler runner as shipped (1500 epochs; the bound of
# tests/test_engines.py:97, the JAX package reached 0.01623, RESULTS.md:74),
# and run_scale_experiment(16, L=8, bn_structured, lr 5e-3), the JAX
# package's best adversarial configuration at scale, for 1000 epochs; its
# limit is the JAX package's best TVD at the same depth and seed in float32
# on a CPU (0.12030 at epoch 999, from 0.83401 at epoch 0;
# scripts/jax_reference_tvd.py) + 0.1.
ADV_SPRINKLER_TVD_MAX = 0.08
ADV16_EPOCHS, ADV16_CHUNK = 1000, 250
ADV16_JAX_TVD = 0.12030
ADV16_TVD_MAX = ADV16_JAX_TVD + 0.1
# n=5 edges: high -> low, low -> high, and two pairs listed twice.
N_BN_EDGES, BN_EDGES = 5, [(4, 0), (2, 1), (0, 3), (0, 3), (3, 4), (1, 2), (1, 2), (4, 2)]

# FP32 tolerances of a kernel against its plain version (cuBLAS FP32, another
# summation order), relative to the largest magnitude of the plain result.
# The backward uncomputes the state through 4 layers of 256-long complex
# sums, so it gets ten times the forward's margin. At n=20 the sums are
# 1024 long, and the grid kernels' plain version is another algorithm: it
# runs the boundary and ring CNOTs as dense W-form products (two more
# 1024-long sums per layer) where the kernel moves amplitudes exactly, so the
# grid pair gets twice the n=16 margins. stein2d_grid is a butterfly of 20
# FMA stages per element at n=20, each rounding once (2^-24 relative), so
# its error is about 20 x 6e-8 = 1.2e-6 of the magnitudes it sums, inside
# 1e-5 of the largest result against the FP32 plain version and against
# float64 alike; stein2d is the same butterfly, at most 17 stages deep.
# stein_gcorr sums 3n+2 terms per output in FP32, their coefficients up to
# 1/(1-a²) (8.5 at n=16, ℓ=1); on the CPU the FP32 plain version read
# 2.6e-7-4e-7 of the largest |y| against float64 on the same inputs (n=13,
# 14, ℓ = 1/n, 2/n, 1), so 1e-5 leaves a 25-fold margin.
TOL = {"circuit2d_fwd": 1e-5, "circuit2d_bwd": 1e-4, "stein2d": 1e-5,
       "circuit2d_grid_fwd": 2e-5, "circuit2d_grid_bwd": 2e-4, "stein2d_grid": 1e-5,
       "stein_gcorr": 1e-5}

REPLACES = {
    "circuit2d_fwd": "tensornetworks_tpu/ops/pallas/circuit2d.py:185",
    "circuit2d_bwd": "tensornetworks_tpu/ops/pallas/circuit2d.py:227",
    "stein2d": "tensornetworks_tpu/ops/pallas/stein2d.py:45",
    "stein2d_grid": "tensornetworks_tpu/ops/pallas/stein2d.py:121",
    "circuit2d_grid_fwd": "tensornetworks_tpu/ops/pallas/circuit2d_grid.py:150",
    "circuit2d_grid_bwd": "tensornetworks_tpu/ops/pallas/circuit2d_grid.py:187",
    # No Pallas kernel: the XLA correction step of stein_matvec_gcorr_tables.
    "stein_gcorr": "tensornetworks_tpu/ops/stein.py:406",
}
SOURCES = {
    "circuit2d_fwd": "tensornetworks_tpu_torch/csrc/circuit2d.cu",
    "circuit2d_bwd": "tensornetworks_tpu_torch/csrc/circuit2d.cu",
    "stein2d": "tensornetworks_tpu_torch/csrc/stein2d.cu",
    "stein2d_grid": "tensornetworks_tpu_torch/csrc/stein2d.cu",
    "circuit2d_grid_fwd": "tensornetworks_tpu_torch/csrc/circuit2d_grid.cu",
    "circuit2d_grid_bwd": "tensornetworks_tpu_torch/csrc/circuit2d_grid.cu",
    "stein_gcorr": "tensornetworks_tpu_torch/csrc/stein_gcorr.cu",
}
# The kernels each path must launch; it must launch no other kernel. The
# bn_structured and exact paths run exactly the kernel sets of main16 and
# scale20.
PATH_KERNELS = {
    "main16": ("circuit2d_fwd", "circuit2d_bwd", "stein2d", "stein_gcorr"),
    "scale20": ("circuit2d_grid_fwd", "circuit2d_grid_bwd", "stein2d_grid", "stein_gcorr"),
}
PATH_KERNELS.update(bn16=PATH_KERNELS["main16"], bn20=PATH_KERNELS["scale20"],
                    sprinkler_classical=(), classical16=("stein2d", "stein_gcorr"),
                    classical20=("stein2d_grid", "stein_gcorr"), sprinkler_adversarial=(),
                    adversarial16=("circuit2d_fwd", "circuit2d_bwd"),
                    exact22=PATH_KERNELS["scale20"], exact24=PATH_KERNELS["scale20"])


class PhaseError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


def time_ms(fn, reps=20, rounds=5, queued=True):
    """Median over rounds of the mean per-call device time of ``reps``
    calls, by CUDA events, after a warm-up call. Each round first queues a
    sleep on the stream (about 0.1 ms a call) for the host to enqueue the
    calls behind, so that the events time them back to back on the device
    and not at the host's enqueue rate: a call through Python and ctypes
    costs the host tens of µs, as much as the smallest kernels take. With
    ``queued=False`` there is no sleep, and a call faster than its host
    cost reads as that cost (``time_tree.py`` compares the two)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * reps)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@functools.lru_cache(maxsize=None)
def path_inputs(n):
    """The n-qubit workload's network, latent names and observation (the
    scale problem: a random chain network of n+1 variables, seed 0); one
    network per n, so that its joint table is built once."""
    from tensornetworks_tpu_torch.runners import make_scale_problem

    return make_scale_problem(n, seed=0)


def path_edges(n):
    """The latent DAG's edges of the n-qubit workload, the bn_structured
    entanglers its engine derives."""
    from tensornetworks_tpu_torch.sim import latent_edges

    bn, latent, _ = path_inputs(n)
    return latent_edges(bn, latent)


def circuit_bounds(R, C, L):
    """(forward, backward) bounds of the circuit kernels' dense products."""
    dense = R * R * C + R * C * C
    return (bound(8 * L * dense, 4 * (2 * L * R * R + 2 * L * C * C + 3 * R * C)),
            bound(24 * L * dense, 4 * (4 * L * R * R + 4 * L * C * C + 3 * R * C)))


def timer(n):
    """``time_ms``, with fewer calls from n = 22."""
    if n < N_EXACT22:
        return time_ms
    return lambda fn: time_ms(fn, reps=WIDE_REPS, rounds=WIDE_ROUNDS)


def check_circuit(n, device, timing, grid=False, ansatz=ANSATZ, layers=LAYERS, edges=None,
                  oracle=True):
    """A circuit kernel pair (circuit2d, or circuit2d_grid with ``grid``)
    against its plain version, and the θ-gradient through the model against
    plain autograd; for bn_structured with ``oracle`` also probabilities and
    θ-gradient against the float64 oracle."""
    import torch
    from tensornetworks_tpu_torch.models import QuantumBornMachine
    from tensornetworks_tpu_torch.ops.kernels import circuit2d as kc
    from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg
    from tensornetworks_tpu_torch.sim.ansatz import num_ansatz_params
    from tensornetworks_tpu_torch.sim.gates import rotation_operators

    if grid:
        name, plan = "circuit2d_grid", kg.GridPlan(n, layers, ansatz, edges)
        fwd, bwd = kg.circuit2d_grid_forward, kg.circuit2d_grid_backward
        fwd_p, bwd_p = kg.circuit2d_grid_forward_plain, kg.circuit2d_grid_backward_plain
        operators = lambda th: kg.grid_operators(th, plan)  # noqa: E731
    else:
        name, plan = "circuit2d", kc.CircuitPlan(n, layers, ansatz, edges)
        fwd, bwd = kc.circuit2d_forward, kc.circuit2d_backward
        fwd_p, bwd_p = kc.circuit2d_forward_plain, kc.circuit2d_backward_plain

        def operators(th):
            Mr, Mc = rotation_operators(th, n, layers, plan.per_qubit)
            return [t.contiguous() for t in (Mr.real, Mr.imag, Mc.real, Mc.imag)]

    def model(backend, dtype=torch.float32):
        return QuantumBornMachine(n, layers, ansatz, backend=backend, dtype=dtype,
                                  device=device, edges=edges)

    gen = torch.Generator().manual_seed(n)
    theta = (0.1 * torch.randn(num_ansatz_params(n, layers, ansatz), generator=gen)).to(device)
    planes = operators(theta)
    out_k = fwd(*planes, plan)
    out_p = fwd_p(*planes, plan)
    torch.cuda.synchronize()
    fwd_err = max(rel_err(a, b) for a, b in zip(out_k, out_p))
    abs_fwd = float((out_k[0] - out_p[0]).abs().max())
    what = f"{name} n={n} L={layers} {ansatz}"
    if edges is not None:
        what += f" ({len(edges)} edges)"
    require(all(bool(torch.isfinite(t).all()) for t in out_k), f"{what}: forward not finite")
    require(abs(float(out_k[0].sum()) - 1.0) < 1e-4, f"{what}: probs do not sum to 1")
    require(fwd_err <= TOL[f"{name}_fwd"], f"{what}: forward rel err {fwd_err:.3e}")

    g = torch.randn((plan.R, plan.C), generator=gen).to(device) * plan.R * plan.C
    grads_k = bwd(*planes, out_k[1], out_k[2], g, plan)
    grads_p = bwd_p(*planes, out_p[1], out_p[2], g, plan)
    torch.cuda.synchronize()
    bwd_err = max(rel_err(a, b) for a, b in zip(grads_k, grads_p))
    abs_bwd = max(float((a - b).abs().max()) for a, b in zip(grads_k, grads_p))
    require(bwd_err <= TOL[f"{name}_bwd"], f"{what}: backward rel err {bwd_err:.3e}")

    # θ-gradients through the model: the kernel Function against plain
    # autograd on the card (through the blocked2d matmul form for the
    # reference ansätze on circuit2d, else through the plain forward).
    v = torch.randn(2**n, generator=gen).to(device)
    th_grads = []
    for plain in (False, True):
        p = theta.clone().requires_grad_(True)
        if plain and (grid or ansatz == BN):
            probs = fwd_p(*operators(p), plan)[0].reshape(-1)
        else:
            probs = model("blocked2d" if plain else name).probs(p)
        (probs @ v).backward()
        th_grads.append(p.grad)
    theta_err = rel_err(*th_grads)
    require(theta_err <= TOL[f"{name}_bwd"], f"{what}: θ-gradient rel err {theta_err:.3e}")
    note = ""
    if ansatz == BN and oracle:
        # The oracle in float64: its own 2x2 rotations applied qubit by qubit
        # and per-edge masked flips, not the Mr/Mc fold and index maps.
        p64 = theta.double().requires_grad_(True)
        q64 = model("structured2d", torch.float64).probs(p64)
        (q64 @ v.double()).backward()
        o_fwd = rel_err(out_k[0].reshape(-1).double(), q64.detach())
        o_grad = rel_err(th_grads[0].double(), p64.grad)
        require(o_fwd <= TOL[f"{name}_fwd"], f"{what}: probs vs oracle rel err {o_fwd:.3e}")
        require(o_grad <= TOL[f"{name}_bwd"], f"{what}: θ-gradient vs oracle rel err "
                                               f"{o_grad:.3e}")
        note = f", vs float64 oracle: probs rel {o_fwd:.2e}, θ-grad rel {o_grad:.2e}"
    print(f"{what}: fwd rel {fwd_err:.2e} (abs {abs_fwd:.2e}), bwd rel {bwd_err:.2e} "
          f"(abs {abs_bwd:.2e}), θ-grad rel {theta_err:.2e}{note}", flush=True)
    if not timing:
        return []
    fwd_bound, bwd_bound = circuit_bounds(plan.R, plan.C, layers)
    t = timer(n)
    return [
        dict(name=f"{name}_fwd", max_abs_err=abs_fwd, rel_err=fwd_err,
             ms=t(lambda: fwd(*planes, plan)),
             plain_ms=t(lambda: fwd_p(*planes, plan)),
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=None),
        dict(name=f"{name}_bwd", max_abs_err=abs_bwd, rel_err=bwd_err,
             ms=t(lambda: bwd(*planes, out_k[1], out_k[2], g, plan)),
             plain_ms=t(lambda: bwd_p(*planes, out_p[1], out_p[2], g, plan)),
             bound_ms=bwd_bound[0], bound_by=bwd_bound[1], library_ms=None),
    ]


def check_bn_circuits(device):
    """The bn_structured cases of the circuit kernels: n=16 and n=20 at L=8
    timed (the bn16 and bn20 paths' shapes and edges), the rest untimed.
    Returns the timed records, each with its n and L."""
    for n in (N_MAX, N_GRID_MIN):  # the largest persistent size; the grid's fewest tiles
        check_circuit(n, device, False, grid=n > N_MAX, ansatz=BN, layers=BN_LAYERS,
                      edges=path_edges(n))
    check_circuit(N_BN_EDGES, device, False, ansatz=BN, layers=5, edges=BN_EDGES)
    check_circuit(N_BN_EDGES, device, False, ansatz=BN, layers=3, edges=[])
    check_circuit(N_GRID_MIN, device, False, grid=True, ansatz=BN, layers=2, edges=[])
    # n=19 (R != C, the first GEMM loop): the DAG's edges reversed, high ->
    # low, in reverse order, and the first one listed twice more.
    flipped = [(t, c) for c, t in reversed(path_edges(N_GRID_ODD))]
    check_circuit(N_GRID_ODD, device, False, grid=True, ansatz=BN, layers=BN_LAYERS,
                  edges=flipped + flipped[:1] * 2)
    records = []
    for n, grid in ((N, False), (N_GRID, True)):
        for r in check_circuit(n, device, True, grid=grid, ansatz=BN, layers=BN_LAYERS,
                               edges=path_edges(n)):
            records.append(dict(r, n=n, layers=BN_LAYERS, share=r["bound_ms"] / r["ms"]))
    return records


def stein_bound(cols, n):
    """The Kronecker apply's least work: the butterfly's FLOPs (one FMA per
    element and stage) and V read once, Y written once."""
    return bound(2 * cols * n * 2**n, 2 * 4 * cols * 2**n)


def check_stein_result(name, n, a, V, y_k):
    """A stein2d kernel's result y_k on V against the plain version in FP32
    and in float64. Returns (max abs error, rel error) against FP32."""
    import torch
    from tensornetworks_tpu_torch.ops.kernels.stein2d import kron_factors, stein2d_apply_plain

    _, R, C = V.shape
    y_p = stein2d_apply_plain(*kron_factors(a, R, C, torch.float32, V.device), V)
    y64 = stein2d_apply_plain(*kron_factors(a, R, C, torch.float64, V.device), V.double())
    torch.cuda.synchronize()
    require(bool(torch.isfinite(y_k).all()), f"{name} n={n}: not finite")
    err, err64 = rel_err(y_k, y_p), rel_err(y_k.double(), y64)
    abs_err = float((y_k - y_p).abs().max())
    require(err <= TOL[name], f"{name} n={n}: rel err {err:.3e}")
    require(err64 <= TOL[name], f"{name} n={n}: rel err {err64:.3e} against float64")
    print(f"{name} n={n}: {V.shape[0]} blocks, rel {err:.2e} (abs {abs_err:.2e}), "
          f"against float64 rel {err64:.2e}", flush=True)
    return abs_err, err


def check_stein2d_random(n, device):
    """stein2d on random columns at an n below the Kronecker path, which
    SteinOperator(dense=False) hands it."""
    import torch
    from tensornetworks_tpu_torch.ops.hamming import decay_factor
    from tensornetworks_tpu_torch.ops.kernels.stein2d import stein2d_apply

    rb = (n + 1) // 2
    gen = torch.Generator().manual_seed(n)
    V = torch.randn((3 * n + 1, 1 << rb, 1 << (n - rb)), generator=gen).to(device)
    a = decay_factor(n, 1.0)
    check_stein_result("stein2d", n, a, V, stein2d_apply(a, V))


def path_config(n, ls=None):
    """(ansatz, layers, edges, length scale) of the KSD path at n qubits:
    main16 (ℓ = 1) or bn16 (ℓ = 1/16, bn_structured L=8) at 16, exact24's
    bn_structured L=8 at 24, otherwise hardware_efficient L=4 at the
    ``auto`` length scale (scale20, exact22)."""
    from tensornetworks_tpu_torch.ops.hamming import resolve_length_scale

    if n == N:
        ls = 1.0 if ls is None else ls
        return (BN, BN_LAYERS, path_edges(n), ls) if ls == BN_LENGTH_SCALE else (
            ANSATZ, LAYERS, None, ls)
    ls = resolve_length_scale("auto", n) if ls is None else ls
    if n == N_EXACT24:
        return BN, BN_LAYERS, path_edges(n), ls
    return ANSATZ, LAYERS, None, ls


@functools.lru_cache(maxsize=1)
def path_operator(n, device, ls=None):
    """The path's Stein operator at n qubits and the Born machine's initial
    q (θ from seed 0, as the engines draw it); the last one is kept for the
    next check at the same n."""
    import torch
    from tensornetworks_tpu_torch.models import QuantumBornMachine
    from tensornetworks_tpu_torch.ops import stein

    ansatz, layers, edges, ls = path_config(n, ls)
    bn, latent, obs = path_inputs(n)
    op = stein.SteinOperator(stein.score_table(bn.conditional_joint_table(latent, obs)), n,
                             length_scale=ls, device=device)
    qbm = QuantumBornMachine(n, layers, ansatz, device=device, edges=edges)
    with torch.no_grad():
        q = qbm.probs(qbm.init(torch.Generator().manual_seed(0)))
    return op, q


def check_stein2d(n, device, timing=True):
    """The path's stein2d kernel (stein2d at n ≤ 17, stein2d_grid above)
    against its plain version in FP32 and float64, on the path's columns:
    the n+1 gcorr columns of its Stein operator at the path's length scale,
    applied to the Born machine's initial q."""
    import torch
    from tensornetworks_tpu_torch.ops.kernels.stein2d import kron_factors, stein2d_apply_plain

    op, q = path_operator(n, device, None)
    name = "stein2d_grid" if op._grid else "stein2d"
    V = op.columns(q)
    cols, R, C = V.shape
    abs_err, err = check_stein_result(name, n, op._a, V, op.kron_apply(V))
    if not timing:
        return []
    Ar, Ac = kron_factors(op._a, R, C, torch.float32, device)
    b = stein_bound(cols, n)
    t = timer(n)
    return [dict(name=name, n=n, cols=cols, max_abs_err=abs_err, rel_err=err,
                 ms=t(lambda: op.kron_apply(V)),
                 plain_ms=t(lambda: stein2d_apply_plain(Ar, Ac, V)),
                 bound_ms=b[0], bound_by=b[1],
                 library_ms=t(lambda: torch.einsum("rs,bsc,dc->brd", Ar, V, Ac)))]


def check_stein2d_3n1(n, device):
    """stein2d on the 3n+1 columns the TPU kernel takes
    (``stein_weight_tables``), untimed."""
    import torch
    from tensornetworks_tpu_torch.ops import stein

    op, q = path_operator(n, device, None)
    Vw, _ = stein.stein_weight_tables(op._score_np, n, op.length_scale)
    V = (torch.as_tensor(Vw, dtype=torch.float32, device=device) * q).reshape(-1, op._R, op._C)
    check_stein_result("stein2d_grid" if op._grid else "stein2d", n, op._a, V, op.kron_apply(V))


def gcorr_bound(n):
    """stein_gcorr's least work: S and Q (n rows each), P0 and Rv read once
    and y written once, against about 9 FLOPs per element and bit."""
    return bound(9 * n * 2**n, (2 * n + 3) * 4 * 2**n)


def check_gcorr(n, device, timing=True, ls=None, f64=False):
    """stein_gcorr against its plain version (FP32, the per-bit flip loop)
    on the path's own P0 and Q, and with ``f64`` against the plain version
    in float64 on the same inputs."""
    import torch
    from tensornetworks_tpu_torch.ops.kernels.stein_gcorr import gcorr_combine, gcorr_combine_plain

    op, q = path_operator(n, device, ls)
    Y = op.kron_apply(op.columns(q)).reshape(n + 1, -1)
    args = (Y[0], Y[1:], op.gcorr.St, op.gcorr.Rv)
    y_k = gcorr_combine(*args, op._a, n)
    y_p = gcorr_combine_plain(*args, op._a, n)
    torch.cuda.synchronize()
    what = f"stein_gcorr n={n} ℓ={op.length_scale:.4g}"
    require(bool(torch.isfinite(y_k).all()), f"{what}: not finite")
    err, abs_err = rel_err(y_k, y_p), float((y_k - y_p).abs().max())
    require(err <= TOL["stein_gcorr"], f"{what}: rel err {err:.3e}")
    note = ""
    if f64:
        y64 = gcorr_combine_plain(*(t.double() for t in args), op._a, n)
        err64 = rel_err(y_k.double(), y64)
        require(err64 <= TOL["stein_gcorr"], f"{what}: rel err {err64:.3e} against float64")
        note = f", against float64 rel {err64:.2e}"
    print(f"{what}: rel {err:.2e} (abs {abs_err:.2e}){note}", flush=True)
    if not timing:
        return []
    b = gcorr_bound(n)
    t = timer(n)
    return [dict(name="stein_gcorr", n=n, length_scale=op.length_scale, max_abs_err=abs_err,
                 rel_err=err, ms=t(lambda: gcorr_combine(*args, op._a, n)),
                 plain_ms=t(lambda: gcorr_combine_plain(*args, op._a, n)),
                 bound_ms=b[0], bound_by=b[1], library_ms=None)]


def check_large_n(device):
    """Step 10's wide checks: stein_gcorr at n = 13 and 14 untimed, at 16
    (ℓ = 1/16, bn16's), 20, 22 and 24 timed; stein2d_grid at 22 and 24 and
    circuit2d_grid (bn_structured, L=8) at 24, timed. Returns the timed
    records."""
    import torch

    def timed(label, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        print(f"  ({label}: {time.perf_counter() - t0:.1f}s)", flush=True)
        return out

    for n in (13, 14):
        check_gcorr(n, device, timing=False)
    records = check_gcorr(N, device, ls=BN_LENGTH_SCALE, f64=True)
    records += check_gcorr(N_GRID, device, f64=True)
    for n in (N_EXACT22, N_EXACT24):
        records += timed(f"stein_gcorr n={n}", check_gcorr, n, device)
        records += timed(f"stein2d_grid n={n}", check_stein2d, n, device)
    path_operator.cache_clear()
    torch.cuda.reset_peak_memory_stats()
    n = N_EXACT24
    records += timed(f"circuit2d_grid n={n}", check_circuit, n, device, True, grid=True,
                     ansatz=BN, layers=BN_LAYERS, edges=path_edges(n), oracle=False)
    print(f"circuit2d_grid n={n} check: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for r in records:
        r.setdefault("n", n)
        r["share"] = r["bound_ms"] / r["ms"]
    return records


# Mangled-name parts of the kernels whose registers are printed on a line of
# their own: the persistent n <= 17 forward and backward, the n <= 17
# cluster butterfly, and the large GEMM loop's scatter instantiation
# (<AK, BKC, CA, CB, SCATTER> = <1, 0, 0, 0, 1>).
NEW_KERNELS = {"circuit2d_fwd_kernel": "circuit2d_fwd_kernel",
               "circuit2d_bwd_kernel": "circuit2d_bwd_kernel",
               "cluster_butterfly_kernel": "cluster_butterfly_kernel",
               "cgemm_large_kernelILb1ELb0ELb0ELb0ELb1EE": "cgemm_large_kernel<scatter>"}


def check_spills(logs, kernels=("cgemm_large_kernel", "butterfly_pass_kernel",
                                "cluster_butterfly_kernel", "circuit2d_fwd_kernel",
                                "circuit2d_bwd_kernel")):
    """Print registers and spills of every compiled function from the ptxas
    reports; the named kernels must spill nothing. Returns the registers of
    each compiled function, by library."""
    import re

    regs = {}
    for lib, log in logs.items():
        func = None
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                func = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and func:
                spilled = int(m.group(1)) + int(m.group(2))
                print(f"  {lib}: {func[:70]}: spill stores {m.group(1)}, loads {m.group(2)}")
                require(not (spilled and any(k in func for k in kernels)),
                        f"{lib}: {func} spills registers")
            elif "registers" in line:
                print(f"  {lib}: {line.strip()}")
                m = re.search(r"Used (\d+) registers", line)
                if m and func:
                    regs.setdefault(lib, {})[func] = int(m.group(1))
    return regs


def print_new_registers(regs):
    """One line with the registers of each NEW_KERNELS instantiation."""
    found = [f"{label} {n} ({lib})" for lib, funcs in sorted(regs.items())
             for func, n in funcs.items() for part, label in NEW_KERNELS.items() if part in func]
    for label in NEW_KERNELS.values():
        require(any(f.startswith(label + " ") for f in found), f"no ptxas report for {label}")
    print("registers of the redesigned kernels: " + ", ".join(found), flush=True)


def check_launches(path, launches):
    """Every kernel of ``path`` launched in its run, and no other kernel."""
    for name, count in launches.items():
        if name in PATH_KERNELS[path]:
            require(count > 0, f"kernel {name} never launched on the {path} path")
        else:
            require(count == 0, f"kernel {name} launched {count}x on the {path} path")


def check_history(path, hist):
    loss = hist["loss_ksd"]
    require(all(math.isfinite(x) for x in loss), f"{path} loss not finite")
    require(loss[-1] < loss[0], f"{path} loss did not fall: {loss[0]} -> {loss[-1]}")
    require(hist["num_skipped_updates"] == 0, f"{path} skipped updates")


def run_main_path(device):
    """The 16-qubit exact KSD-VI trainer, through the user entry point."""
    import torch
    from tensornetworks_tpu_torch.core import all_bitstrings
    from tensornetworks_tpu_torch.engines import QuantumKSDVariationalInference
    from tensornetworks_tpu_torch.models import QuantumBornMachine
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.ops.stein import score_table, stein_matvec

    bn, latent, obs = path_inputs(N)
    post = bn.posterior_vector(latent, obs)
    eng = QuantumKSDVariationalInference(bn, latent, list(obs), qbm_num_latent_vars=N,
                                         qbm_ansatz_layers=LAYERS, qbm_ansatz_type=ANSATZ,
                                         seed=0, device=device)
    require(eng.born_machine.backend == "circuit2d", "main path is not on circuit2d")
    theta0 = eng.params.clone()
    kernels.reset_launches()
    hist = eng.train(obs, num_epochs=MAIN_EPOCHS, lr_born_machine=5e-3, verbose=False,
                     true_posterior_for_tvd=post, chunk_epochs=MAIN_EPOCHS // 3)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_history("main16", hist)
    check_launches("main16", launches)
    loss = hist["loss_ksd"]
    # The first epoch's loss against a float64 plain evaluation of the same
    # θ: the blocked2d circuit and the 3n+1-column Stein oracle.
    ref_qbm = QuantumBornMachine(N, LAYERS, ANSATZ, backend="blocked2d", dtype=torch.float64,
                                 device=device)
    f64 = dict(dtype=torch.float64, device=device)
    S = torch.as_tensor(score_table(bn.conditional_joint_table(latent, obs)), **f64)
    B = torch.as_tensor(all_bitstrings(N), **f64)
    with torch.no_grad():
        q = ref_qbm.probs(theta0.double())
        ref_loss = math.sqrt(max(float(q @ stein_matvec(q, S, B, N)), 1e-12))
    loss_err = abs(loss[0] - ref_loss) / abs(ref_loss)
    require(loss_err < 1e-4, f"main path epoch-0 loss {loss[0]} vs float64 {ref_loss}")
    eps = hist.get("epochs_per_sec_steady", hist["epochs_per_sec"])
    print(f"main path: {MAIN_EPOCHS} epochs, loss {loss[0]:.5f} -> {loss[-1]:.5f} "
          f"(epoch-0 rel err vs float64 {loss_err:.1e}), best TVD {eng.best_tvd_:.5f}, "
          f"{eps:.1f} epochs/s steady, launches {launches}", flush=True)
    return launches, eps


def run_scale_path(device):
    """The 20-qubit exact KSD-VI run through ``run_scale_experiment``."""
    import torch
    from tensornetworks_tpu_torch.core import all_bitstrings
    from tensornetworks_tpu_torch.models import QuantumBornMachine
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.ops.hamming import resolve_length_scale
    from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg
    from tensornetworks_tpu_torch.ops.stein import score_table, stein_matvec
    from tensornetworks_tpu_torch.runners import run_scale_experiment

    n = N_GRID
    # The run's initial θ: the engine draws it from its seed exactly so.
    theta0 = QuantumBornMachine(n, LAYERS, ANSATZ, device=device).init(
        torch.Generator().manual_seed(0))
    kernels.reset_launches()
    out = run_scale_experiment(num_qubits=n, layers=LAYERS, num_epochs=SCALE_EPOCHS,
                               chunk_epochs=SCALE_CHUNK, lr=5e-3, seed=0, track_tvd=True,
                               verbose=False, device=device)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    model, hist = out["model"], out["history"]
    require(model.born_machine.backend == "circuit2d_grid",
            f"scale20 path is on {model.born_machine.backend}, not circuit2d_grid")
    check_history("scale20", hist)
    check_launches("scale20", launches)
    loss = hist["loss_ksd"]
    # Epoch 0's loss against a float64 plain evaluation of the same θ: the
    # grid kernels' plain circuit and the 3n+1-column Stein oracle, at the
    # run's length scale ("auto": 2/n).
    bn, latent, obs = path_inputs(n)
    plan = kg.GridPlan(n, LAYERS, ANSATZ)
    f64 = dict(dtype=torch.float64, device=device)
    S = torch.as_tensor(score_table(bn.conditional_joint_table(latent, obs)), **f64)
    B = torch.as_tensor(all_bitstrings(n), **f64)
    with torch.no_grad():
        q = kg.circuit2d_grid_forward_plain(*kg.grid_operators(theta0.double(), plan),
                                            plan)[0].reshape(-1)
        y = stein_matvec(q, S, B, n, resolve_length_scale("auto", n))
        ref_loss = math.sqrt(max(float(q @ y), 1e-12))
    loss_err = abs(loss[0] - ref_loss) / abs(ref_loss)
    require(loss_err < 1e-4, f"scale20 epoch-0 loss {loss[0]} vs float64 {ref_loss}")
    eps = hist.get("epochs_per_sec_steady", hist["epochs_per_sec"])
    print(f"scale20 path: {SCALE_EPOCHS} epochs, loss {loss[0]:.5f} -> {loss[-1]:.5f} "
          f"(epoch-0 rel err vs float64 {loss_err:.1e}), best TVD {model.best_tvd_:.5f}, "
          f"{eps:.2f} epochs/s steady, launches {launches}", flush=True)
    return launches, eps


def bn_reference_loss(n, theta0, length_scale):
    """The KSD loss of θ0 on the n-qubit workload in float64: the
    bn_structured oracle (per-edge flips) and the 3n+1-column Stein oracle."""
    import torch
    from tensornetworks_tpu_torch.core import all_bitstrings
    from tensornetworks_tpu_torch.ops.stein import score_table, stein_matvec
    from tensornetworks_tpu_torch.sim import make_structured_probs_fn

    bn, latent, obs = path_inputs(n)
    f64 = dict(dtype=torch.float64, device=theta0.device)
    S = torch.as_tensor(score_table(bn.conditional_joint_table(latent, obs)), **f64)
    B = torch.as_tensor(all_bitstrings(n), **f64)
    with torch.no_grad():
        q = make_structured_probs_fn(n, BN_LAYERS, path_edges(n))(theta0.double())
        return math.sqrt(max(float(q @ stein_matvec(q, S, B, n, length_scale)), 1e-12))


def check_bn_run(path, hist, launches, theta0, length_scale, n):
    """A bn path's history and launches, and its epoch-0 loss against float64."""
    check_history(path, hist)
    check_launches(path, launches)
    loss = hist["loss_ksd"]
    ref_loss = bn_reference_loss(n, theta0, length_scale)
    loss_err = abs(loss[0] - ref_loss) / abs(ref_loss)
    require(loss_err < 1e-4, f"{path} epoch-0 loss {loss[0]} vs float64 {ref_loss}")
    return loss_err


def run_bn16_path(device):
    """bench.py's quality configuration for 3000 epochs: bn_structured at 16
    qubits, L=8, length scale 0.0625, lr 0.05, through the engine."""
    import torch
    from tensornetworks_tpu_torch.engines import QuantumKSDVariationalInference
    from tensornetworks_tpu_torch.ops import kernels

    bn, latent, obs = path_inputs(N)
    post = bn.posterior_vector(latent, obs)
    eng = QuantumKSDVariationalInference(bn, latent, list(obs), qbm_num_latent_vars=N,
                                         qbm_ansatz_layers=BN_LAYERS, qbm_ansatz_type=BN,
                                         base_kernel_length_scale=BN_LENGTH_SCALE, seed=0,
                                         device=device)
    require(eng.born_machine.backend == "circuit2d", "bn16 path is not on circuit2d")
    theta0 = eng.params.clone()
    kernels.reset_launches()
    hist = eng.train(obs, num_epochs=BN16_EPOCHS, lr_born_machine=BN_LR, verbose=False,
                     true_posterior_for_tvd=post, chunk_epochs=BN16_CHUNK)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    loss_err = check_bn_run("bn16", hist, launches, theta0, BN_LENGTH_SCALE, N)
    require(eng.best_tvd_ <= BN16_TVD_MAX,
            f"bn16 best TVD {eng.best_tvd_} > {BN16_TVD_MAX} after {BN16_EPOCHS} epochs")
    loss = hist["loss_ksd"]
    eps = hist.get("epochs_per_sec_steady", hist["epochs_per_sec"])
    print(f"bn16 path: {BN16_EPOCHS} epochs, {len(eng.born_machine.edges)} edges, loss "
          f"{loss[0]:.5f} -> {loss[-1]:.5f} (epoch-0 rel err vs float64 {loss_err:.1e}), "
          f"best TVD {eng.best_tvd_:.5f} (limit {BN16_TVD_MAX}) at epoch {eng.best_epoch_}, "
          f"{eps:.1f} epochs/s steady, launches {launches}", flush=True)
    return launches, eps


def run_bn20_path(device):
    """The 20-qubit bn_structured run (L=8) through ``run_scale_experiment``."""
    import torch
    from tensornetworks_tpu_torch.models import QuantumBornMachine
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.ops.hamming import resolve_length_scale
    from tensornetworks_tpu_torch.runners import run_scale_experiment

    n = N_GRID
    # The run's initial θ: the engine draws it from its seed exactly so.
    theta0 = QuantumBornMachine(n, BN_LAYERS, BN, device=device, edges=path_edges(n)).init(
        torch.Generator().manual_seed(0))
    kernels.reset_launches()
    out = run_scale_experiment(num_qubits=n, layers=BN_LAYERS, ansatz=BN, num_epochs=BN20_EPOCHS,
                               chunk_epochs=BN20_CHUNK, lr=BN_LR, seed=0, track_tvd=True,
                               verbose=False, device=device)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    model, hist = out["model"], out["history"]
    require(model.born_machine.backend == "circuit2d_grid",
            f"bn20 path is on {model.born_machine.backend}, not circuit2d_grid")
    loss_err = check_bn_run("bn20", hist, launches, theta0, resolve_length_scale("auto", n), n)
    loss = hist["loss_ksd"]
    eps = hist.get("epochs_per_sec_steady", hist["epochs_per_sec"])
    print(f"bn20 path: {BN20_EPOCHS} epochs, loss {loss[0]:.5f} -> {loss[-1]:.5f} "
          f"(epoch-0 rel err vs float64 {loss_err:.1e}), best TVD {model.best_tvd_:.5f}, "
          f"{eps:.2f} epochs/s steady, launches {launches}", flush=True)
    return launches, eps


def run_sprinkler(device):
    from tensornetworks_tpu_torch.runners import run_sprinkler_quantum_ksd_experiment

    out = run_sprinkler_quantum_ksd_experiment(verbose=False, device=device)
    best = out["model"].best_tvd_
    print(f"sprinkler: best TVD {best:.5f} (limit {SPRINKLER_TVD_MAX}), "
          f"final TVD {out['final_tvd']:.5f}, "
          f"{out['history']['epochs_per_sec']:.1f} epochs/s", flush=True)
    require(best <= SPRINKLER_TVD_MAX, f"sprinkler best TVD {best} > {SPRINKLER_TVD_MAX}")


def classical_reference_loss(n, table0):
    """The KSD of softmax(table0) on the n-qubit workload in float64 (ℓ = 1):
    the 3n+1-column Stein oracle."""
    import torch
    from tensornetworks_tpu_torch.core import all_bitstrings
    from tensornetworks_tpu_torch.ops.stein import score_table, stein_matvec

    bn, latent, obs = path_inputs(n)
    f64 = dict(dtype=torch.float64, device=table0.device)
    S = torch.as_tensor(score_table(bn.conditional_joint_table(latent, obs)), **f64)
    B = torch.as_tensor(all_bitstrings(n), **f64)
    with torch.no_grad():
        q = torch.softmax(table0.double(), dim=0)
        return math.sqrt(max(float(q @ stein_matvec(q, S, B, n, 1.0)), 1e-12))


def run_sprinkler_classical(device):
    """The Sprinkler classical KSD runner as shipped, then with a table."""
    import torch
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.runners import ClassicalKSDConfig, run_sprinkler_ksd_experiment

    kernels.reset_launches()
    out = run_sprinkler_ksd_experiment(verbose=False, device=device)
    table = run_sprinkler_ksd_experiment(ClassicalKSDConfig(conditioning_dim=0), verbose=False,
                                         device=device)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_launches("sprinkler_classical", launches)
    rows = []
    for label, o, limit in (("conditional MLP", out, CLASSICAL_SPRINKLER_TVD_MAX),
                            ("table", table, CLASSICAL_TABLE_TVD_MAX)):
        best, hist = o["model"].best_tvd_, o["history"]
        require(best <= limit, f"sprinkler_classical ({label}) best TVD {best} > {limit}")
        require(abs(o["final_tvd"] - best) < 1e-5,
                f"sprinkler_classical ({label}) restored TVD {o['final_tvd']} != best {best}")
        rows.append(f"{label}: best TVD {best:.5f} (limit {limit}) at epoch "
                    f"{o['model'].best_epoch_}, {len(hist['tvd'])} epochs run, "
                    f"{hist['epochs_per_sec']:.1f} epochs/s")
    print("sprinkler_classical path: " + "; ".join(rows) + f", launches {launches}", flush=True)
    return launches, out["history"]["epochs_per_sec"]


def run_classical_path(path, n, epochs, device, chunk=None):
    """KSD-VI of a 2^n softmax table on the n-qubit workload through
    ``KSDVariationalInference`` (ℓ = 1, lr 5e-3, clip 5, entropy 1e-3,
    patience 200)."""
    import torch
    from tensornetworks_tpu_torch.engines import KSDVariationalInference
    from tensornetworks_tpu_torch.ops import kernels

    bn, latent, obs = path_inputs(n)
    post = bn.posterior_vector(latent, obs)
    eng = KSDVariationalInference(bn, latent, list(obs), {"conditioning_dim": 0},
                                  base_kernel_length_scale=1.0, seed=0, device=device)
    table0 = eng.params.clone()
    kernels.reset_launches()
    hist = eng.train(obs, num_epochs=epochs, lr_born_machine=5e-3, verbose=False,
                     true_posterior_for_tvd=post, gradient_clip_norm=5.0, entropy_weight=1e-3,
                     patience=200, chunk_epochs=chunk)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_history(path, hist)
    check_launches(path, launches)
    loss = hist["loss_ksd"]
    ref_loss = classical_reference_loss(n, table0)
    loss_err = abs(loss[0] - ref_loss) / abs(ref_loss)
    require(loss_err < 1e-4, f"{path} epoch-0 loss {loss[0]} vs float64 {ref_loss}")
    eps = hist.get("epochs_per_sec_steady", hist["epochs_per_sec"])
    print(f"{path} path: {len(loss)} of {epochs} epochs, loss {loss[0]:.5f} -> {loss[-1]:.5f} "
          f"(epoch-0 rel err vs float64 {loss_err:.1e}), best TVD {eng.best_tvd_:.5f} at "
          f"epoch {eng.best_epoch_}, {eps:.1f} epochs/s steady, launches {launches}", flush=True)
    return launches, eps, eng


def run_classical16_path(device):
    launches, eps, eng = run_classical_path("classical16", N, CLASSICAL16_EPOCHS, device)
    require(eng.best_tvd_ <= CLASSICAL16_TVD_MAX,
            f"classical16 best TVD {eng.best_tvd_} > {CLASSICAL16_TVD_MAX}")
    return launches, eps


def run_classical20_path(device):
    launches, eps, _ = run_classical_path("classical20", N_GRID, CLASSICAL20_EPOCHS, device,
                                          chunk=CLASSICAL20_EPOCHS // 3)
    return launches, eps


def check_adversarial_history(path, hist):
    """Every epoch's two losses finite (so no update was skipped), and the
    best TVD below epoch 0's (the run is not frozen)."""
    for key in ("loss_classifier", "loss_born_machine"):
        require(all(math.isfinite(x) for x in hist[key]), f"{path} {key} not finite")
    tvd = hist["tvd"]
    require(min(tvd) < tvd[0], f"{path} best TVD {min(tvd)} not below epoch 0's {tvd[0]}")


def run_sprinkler_adversarial(device):
    """The Sprinkler adversarial runner as shipped (1500 epochs)."""
    import torch
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.runners import run_sprinkler_experiment

    kernels.reset_launches()
    out = run_sprinkler_experiment(verbose=False, device=device)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_launches("sprinkler_adversarial", launches)
    hist, best = out["history"], out["model"].best_tvd_
    check_adversarial_history("sprinkler_adversarial", hist)
    require(best <= ADV_SPRINKLER_TVD_MAX,
            f"sprinkler_adversarial best TVD {best} > {ADV_SPRINKLER_TVD_MAX}")
    eps = hist.get("epochs_per_sec_steady", hist["epochs_per_sec"])
    print(f"sprinkler_adversarial path: best TVD {best:.5f} (limit {ADV_SPRINKLER_TVD_MAX}) at "
          f"epoch {out['model'].best_epoch_}, final TVD {out['final_tvd']:.5f}, "
          f"{eps:.1f} epochs/s, launches {launches}", flush=True)
    return launches, eps


def run_adversarial16_path(device):
    """``run_scale_experiment(16, L=8, objective="adversarial",
    ansatz="bn_structured", lr=5e-3)``: REINFORCE through the circuit
    kernels, the discriminator in plain torch."""
    import numpy as np
    import torch
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.runners import run_scale_experiment

    kernels.reset_launches()
    out = run_scale_experiment(num_qubits=N, layers=BN_LAYERS, objective="adversarial",
                               ansatz=BN, lr=5e-3, num_epochs=ADV16_EPOCHS,
                               chunk_epochs=ADV16_CHUNK, seed=0, verbose=False, device=device)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    model, hist = out["model"], out["history"]
    require(model.born_machine.backend == "circuit2d", "adversarial16 is not on circuit2d")
    check_launches("adversarial16", launches)
    check_adversarial_history("adversarial16", hist)
    _, _, obs = path_inputs(N)
    raw = model._log_p_x_given_z_table(obs)
    require(np.isfinite(np.clip(raw, -60.0, 60.0)).all(), "adversarial16 log p table not finite")
    require(model.best_tvd_ <= ADV16_TVD_MAX,
            f"adversarial16 best TVD {model.best_tvd_} > {ADV16_TVD_MAX}")
    eps = hist.get("epochs_per_sec_steady", hist["epochs_per_sec"])
    print(f"adversarial16 path: {ADV16_EPOCHS} epochs, TVD {hist['tvd'][0]:.5f} -> best "
          f"{model.best_tvd_:.5f} (limit {ADV16_TVD_MAX:.5f}) at epoch {model.best_epoch_}, "
          f"{int((~np.isfinite(raw)).sum())} infinite log p(x|z) entries before the floor, "
          f"{eps:.1f} epochs/s steady, launches {launches}", flush=True)
    return launches, eps


def gcorr_reference_loss(n, q64, S, length_scale):
    """The KSD loss of the float64 distribution q64 on the device for the
    score table S (host float64): the gcorr columns through the dense
    two-sided Kronecker split in float64, then the plain recombination."""
    import torch
    from tensornetworks_tpu_torch.ops.hamming import decay_factor
    from tensornetworks_tpu_torch.ops.kernels.stein2d import kron_factors, stein2d_apply_plain
    from tensornetworks_tpu_torch.ops.kernels.stein_gcorr import gcorr_combine_plain
    from tensornetworks_tpu_torch.ops.stein import gcorr_columns, make_gcorr_tables

    a = decay_factor(n, length_scale)
    rb = (n + 1) // 2
    R, C = 1 << rb, 1 << (n - rb)
    with torch.no_grad():
        St, Rv = make_gcorr_tables(S, n, dtype=torch.float64, device=q64.device)
        V = gcorr_columns(q64, St).reshape(-1, R, C)
        Y = stein2d_apply_plain(*kron_factors(a, R, C, torch.float64, q64.device), V)
        del V
        Y = Y.reshape(n + 1, -1)
        y = gcorr_combine_plain(Y[0], Y[1:], St, Rv, a, n)
        return math.sqrt(max(float(q64 @ y), 1e-12))


def run_exact22_path(device):
    """The tempered target at 22 qubits: ``run_scale_experiment(22, L=4,
    temper_betas=[0.5, 1.0])``, hardware_efficient, chunks of 10 epochs."""
    import torch
    from tensornetworks_tpu_torch.engines import QuantumKSDVariationalInference
    from tensornetworks_tpu_torch.models import QuantumBornMachine
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.ops.hamming import resolve_length_scale
    from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg
    from tensornetworks_tpu_torch.ops.stein import score_table
    from tensornetworks_tpu_torch.runners import run_scale_experiment

    n = N_EXACT22
    theta0 = QuantumBornMachine(n, LAYERS, ANSATZ, device=device).init(
        torch.Generator().manual_seed(0))
    built = []
    build = QuantumKSDVariationalInference.build_operator

    def counted(self, x, temper_beta=1.0):
        built.append(temper_beta)
        return build(self, x, temper_beta)

    QuantumKSDVariationalInference.build_operator = counted
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = run_scale_experiment(num_qubits=n, layers=LAYERS, num_epochs=EXACT22_EPOCHS,
                                   chunk_epochs=EXACT22_CHUNK, temper_betas=EXACT22_BETAS,
                                   seed=0, verbose=False, device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        QuantumKSDVariationalInference.build_operator = build
    model, hist = out["model"], out["history"]
    require(model.born_machine.backend == "circuit2d_grid",
            f"exact22 path is on {model.born_machine.backend}, not circuit2d_grid")
    check_launches("exact22", launches)
    loss = hist["loss_ksd"]
    require(all(math.isfinite(x) for x in loss), "exact22 loss not finite")
    require(hist["num_skipped_updates"] == 0, "exact22 skipped updates")
    require(sorted(built) == sorted(EXACT22_BETAS),
            f"exact22 built operators for β = {built}, want one each for {EXACT22_BETAS}")
    # Epoch 0 trains against p^0.5: its loss against the β = 0.5 operator's
    # in float64 (the grid kernels' plain circuit, the gcorr plain version).
    bn, latent, obs = path_inputs(n)
    S = 1.0 - (1.0 - score_table(bn.conditional_joint_table(latent, obs))) ** EXACT22_BETAS[0]
    plan = kg.GridPlan(n, LAYERS, ANSATZ)
    with torch.no_grad():
        q64 = kg.circuit2d_grid_forward_plain(*kg.grid_operators(theta0.double(), plan),
                                              plan)[0].reshape(-1)
    ref_loss = gcorr_reference_loss(n, q64, S, resolve_length_scale("auto", n))
    loss_err = abs(loss[0] - ref_loss) / abs(ref_loss)
    require(loss_err < 1e-4, f"exact22 epoch-0 loss {loss[0]} vs float64 {ref_loss}")
    eps = hist.get("epochs_per_sec_steady", hist["epochs_per_sec"])
    print(f"exact22 path: {EXACT22_EPOCHS} epochs, β {EXACT22_BETAS} per chunk of "
          f"{EXACT22_CHUNK}, operators built for β {built}, loss {loss[0]:.5f} -> "
          f"{loss[-1]:.5f} (epoch-0 rel err vs float64 β=0.5 {loss_err:.1e}), "
          f"{eps:.2f} epochs/s steady, {seconds:.1f}s in run_scale_experiment, "
          f"launches {launches}", flush=True)
    return launches, eps


def run_exact24_path(device):
    """The widest exact path: ``run_scale_experiment(24, L=8,
    ansatz="bn_structured", lr=0.05, track_tvd=True)``, 10 epochs in chunks
    of 5."""
    import torch
    from tensornetworks_tpu_torch.models import QuantumBornMachine
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.ops.hamming import resolve_length_scale
    from tensornetworks_tpu_torch.ops.stein import score_table
    from tensornetworks_tpu_torch.runners import run_scale_experiment
    from tensornetworks_tpu_torch.sim import make_structured_probs_fn

    n = N_EXACT24
    edges = path_edges(n)
    theta0 = QuantumBornMachine(n, BN_LAYERS, BN, device=device, edges=edges).init(
        torch.Generator().manual_seed(0))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = run_scale_experiment(num_qubits=n, layers=BN_LAYERS, ansatz=BN, lr=BN_LR,
                               num_epochs=EXACT24_EPOCHS, chunk_epochs=EXACT24_CHUNK,
                               track_tvd=True, seed=0, verbose=False, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, hist = out["model"], out["history"]
    require(model.born_machine.backend == "circuit2d_grid",
            f"exact24 path is on {model.born_machine.backend}, not circuit2d_grid")
    check_launches("exact24", launches)
    loss, tvd = hist["loss_ksd"], hist["tvd"]
    require(all(math.isfinite(x) for x in loss), "exact24 loss not finite")
    require(hist["num_skipped_updates"] == 0, "exact24 skipped updates")
    first = statistics.mean(loss[:EXACT24_CHUNK])
    last = statistics.mean(loss[-EXACT24_CHUNK:])
    require(last < first, f"exact24 last chunk's mean loss {last} not below the first's {first}")
    require(all(math.isfinite(x) for x in tvd) and math.isfinite(model.best_tvd_),
            "exact24 TVD not finite")
    # Epoch 0's loss in float64: the bn_structured oracle and the gcorr plain
    # version (the 3n+1 oracle's float64 columns and tables would take about
    # 30 GB here).
    bn, latent, obs = path_inputs(n)
    S = score_table(bn.conditional_joint_table(latent, obs))
    with torch.no_grad():
        q64 = make_structured_probs_fn(n, BN_LAYERS, edges)(theta0.double())
    ref_loss = gcorr_reference_loss(n, q64, S, resolve_length_scale("auto", n))
    loss_err = abs(loss[0] - ref_loss) / abs(ref_loss)
    require(loss_err < 1e-4, f"exact24 epoch-0 loss {loss[0]} vs float64 {ref_loss}")
    steady = hist.get("epochs_per_sec_steady")
    require(steady is not None, "exact24 has no steady rate")
    print(f"exact24 path: {EXACT24_EPOCHS} epochs, {len(edges)} edges, loss {loss[0]:.5f} -> "
          f"{loss[-1]:.5f}, chunk means {first:.5f} -> {last:.5f} (epoch-0 rel err vs float64 "
          f"{loss_err:.1e}), TVD {tvd[0]:.5f} -> {tvd[-1]:.5f}, best {model.best_tvd_:.5f}, "
          f"{hist['epochs_per_sec']:.3f} epochs/s, {steady:.3f} epochs/s steady, "
          f"{seconds:.1f}s in run_scale_experiment, peak device memory {peak:.2f} GiB, "
          f"launches {launches}", flush=True)
    return launches, steady


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import tensornetworks_tpu_torch  # noqa: F401  (sets FP32 matmul precision)
    from tensornetworks_tpu_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    t_start = time.perf_counter()

    def phase(label, t0):
        now = time.perf_counter()
        print(f"phase {label}: {now - t0:.1f}s", flush=True)
        return now

    t0 = time.perf_counter()
    kernels.build_all()
    print(f"built kernels in {time.perf_counter() - t0:.1f}s", flush=True)
    from tensornetworks_tpu_torch.ops.kernels import _lib
    print_new_registers(check_spills(_lib.BUILD_LOGS))
    t0 = phase("build", t0)

    for n in (N_MIN, N_RAGGED, N_ODD, N_MAX):  # ragged tiles (R=4, C=2); odd, R != C
        check_circuit(n, device, timing=False)
    check_circuit(N_NO_WALL, device, timing=False, ansatz="basic")  # no Hadamard wall
    for n in N_STEIN_RANDOM:
        check_stein2d_random(n, device)
    for n in N_STEIN:
        check_stein2d(n, device, timing=False)
    check_stein2d_3n1(N, device)  # the 3n+1 columns the TPU kernel takes
    for n in (N_GRID_MIN, N_GRID_ODD):  # fewest tiles; R != C, both GEMM loops
        check_circuit(n, device, timing=False, grid=True)
        check_stein2d(n, device, timing=False)
    check_circuit(N_GRID_WIDE, device, timing=False, grid=True)  # scatter on the large loop
    records = [dict(r, path="main16") for r in (
        check_circuit(N, device, timing=True) + check_stein2d(N, device)
        + check_gcorr(N, device, f64=True))]
    records += [dict(r, path="scale20") for r in (
        check_circuit(N_GRID, device, timing=True, grid=True) + check_stein2d(N_GRID, device))]
    t0 = phase("kernel checks", t0)
    bn_records = check_bn_circuits(device)
    t0 = phase("bn_structured kernel checks", t0)
    wide_records = check_large_n(device)
    t0 = phase("large-n kernel checks", t0)
    path_launches = {}
    path_launches["main16"], eps = run_main_path(device)
    t0 = phase("main16 path", t0)
    path_launches["scale20"], eps20 = run_scale_path(device)
    t0 = phase("scale20 path", t0)
    path_launches["bn16"], eps_bn16 = run_bn16_path(device)
    t0 = phase("bn16 path", t0)
    path_launches["bn20"], eps_bn20 = run_bn20_path(device)
    t0 = phase("bn20 path", t0)
    run_sprinkler(device)
    t0 = phase("sprinkler", t0)
    new_paths = {}
    for path, run in (("sprinkler_classical", run_sprinkler_classical),
                      ("classical16", run_classical16_path),
                      ("classical20", run_classical20_path),
                      ("sprinkler_adversarial", run_sprinkler_adversarial),
                      ("adversarial16", run_adversarial16_path),
                      ("exact22", run_exact22_path),
                      ("exact24", run_exact24_path)):
        path_launches[path], new_paths[path] = run(device)
        t0 = phase(f"{path} path", t0)

    kernels_line = []
    for r in records:
        kernels_line.append({
            "name": r["name"], "route": "cuda", "source": SOURCES[r["name"]],
            "replaces": REPLACES[r["name"]],
            "launches": path_launches[r["path"]][r["name"]],
            "launches_by_path": {p: c[r["name"]] for p, c in path_launches.items()
                                 if r["name"] in PATH_KERNELS[p]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    require(sorted(k["name"] for k in kernels_line) == sorted(SOURCES),
            "the kernels line does not list every kernel")
    bn_path = {k: path for path in ("bn16", "bn20") for k in PATH_KERNELS[path]}
    bn_line = []
    for r in bn_records:
        path = bn_path[r["name"]]
        bn_line.append({k: r[k] for k in ("name", "n", "layers", "max_abs_err", "rel_err", "ms",
                                          "plain_ms", "bound_ms", "bound_by", "share")}
                       | {"path": path, "launches": path_launches[path][r["name"]]})
    wide_path = {N: "bn16", N_GRID: "scale20", N_EXACT22: "exact22", N_EXACT24: "exact24"}
    wide_line = [{k: r[k] for k in ("name", "n", "max_abs_err", "rel_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms", "share")}
                 | {"path": wide_path[r["n"]],
                    "launches": path_launches[wide_path[r["n"]]][r["name"]]}
                 for r in wide_records]
    print(f"main path {eps:.2f} epochs/s, scale20 path {eps20:.2f} epochs/s, bn16 path "
          f"{eps_bn16:.2f} epochs/s, bn20 path {eps_bn20:.2f} epochs/s, "
          + "".join(f"{p} path {e:.2f} epochs/s, " for p, e in new_paths.items())
          + f"on {card}; "
          f"{time.perf_counter() - t_start:.1f}s in all")
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"bn_structured": bn_line}))
    print(json.dumps({"large_n": wide_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
