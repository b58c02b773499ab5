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
   First, the lean distributed executor's kernels at a rank's shape of the
   n=32 cell on four cards (30 local bits, pieces of 2^26 amplitudes):
   each shard pass forward and adjoint, each tile's dU record, the reduce
   and the global-pair combines against their float64 plain versions on
   the card, timed (``check_shard_passes``, ``check_pair_kernels``).
   Each circuit2d_grid check runs the dense-operator kernels in FP32 and,
   beside them on the same θ, the gate path that the FP32 machines take
   from 18 qubits (``csrc/circuit_gates.cu``, ``check_gates``): forward and
   dU against their plain version, bit-equal over two runs, timed where
   the grid check is.
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
   at n = 24 against their plain versions; the gate path past the dense
   path's range at sampled28's shape (n = 28, HE L=4), timed, bit-equal
   over two runs, its probabilities and the θ-gradient of a loss on 1024
   shots against the blocked adjoint executor's (``check_wide_gates``).
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
12. Sampled KSD (``SampledKSDVariationalInference``), first its ops on the
   card: ``sample_indices`` at n=16 (the inverse-CDF branch) and
   ``sample_indices_2d`` at n=20 and 28 on the Born machines' initial q
   (1024 shots) against their float64 evaluation on the CPU on the same
   uniforms, where an index may differ only at a rounding tie (its uniform
   within 1e-6 of the CDF step it crossed; the count is printed); the
   blocked CDF scan of a 2^24 q and the log-q gather's backward, each
   three times bit-equal and against float64 (``sampler replay``);
   ``stein_gram_samples`` at n=24, M=1024, against float64 on the same
   samples and scores; the blocked adjoint's probabilities and θ-gradient
   against the circuit2d_grid kernels' at n = 20 and 24 (same θ, same
   upstream gradient: two independent algorithms). Then four paths:
   sampled16 (``scripts/quality_sampled.py``'s defaults: bn_structured
   L=8, ℓ = 1/16, 1024 shots, loo, one phase of 2000 epochs at lr 0.05,
   eval on the loss forward), circuit kernels 1-2 only, every loss finite,
   best TVD within 0.1 of the JAX package's on the same configuration, then
   run again with the same seed: its loss, TVD and gradient-norm histories,
   best TVD and best epoch equal the first run's bit for bit (the shots'
   CDF scan and the log-q gather's backward are deterministic);
   sampled24 (``examples/sampled_ksd_large_n.py``, HE L=4, two-stage shots,
   TVD against the exact 2^24 posterior, cut to 20 epochs in chunks of
   10), kernels 5-6 only, epoch 0's U-statistic against float64 on the
   recorded shots; sampled28 (``scripts/probe_sampled_28.py``, cut to 6
   epochs in chunks of 3), kernels 5-6 on the gate path. Both wide paths: every loss finite, no skipped update, the last
   chunk's mean U-statistic below the first's. sampling20:
   ``run_sampling_throughput(20, layers=2, num_samples=65536)``, kernel 5
   only.
13. Amortized inference and distillation (conditioned Born machines, whose
   RY wall is folded into the circuit kernels' operator planes). First the
   conditioned kernel checks: one forward and θ-gradient (the learned
   embedding W and the per-layer scales s included) through the kernels
   against the float64 plain path, at n=16 (bn_structured L=8, the wall
   re-uploaded before every layer, learned embedding with per-layer
   scales, d=2) and n=20 (hardware_efficient L=4, one fixed wall, folded
   before the grid's row gather). Then four paths: amortized16
   (``scripts/quality_amortized16.py``'s model: a random chain network of
   18 variables, seed 0, V16 and V17 observed, so 4 observations;
   bn_structured L=8, re-uploading, ℓ = 1/16, clip 10, entropy 0; one phase
   of 2000 epochs at lr 0.05 in chunks of 500), kernels 1-2, stein2d and
   stein_gcorr launched 4 times an epoch (the circuit forward 4 more for
   the final evaluation), every loss finite, the best mean TVD below epoch
   0's and within 0.1 of the JAX package's on the same configuration,
   epoch 0's loss against float64; amortized20
   (``run_amortized_experiment(20, quantum=True, layers=4)``, 20 epochs in
   chunks of 10), the grid kernels, stein2d_grid and stein_gcorr, no
   skipped update, epoch 0 against float64, the per-observation TVDs
   printed; warm16 (``run_scale_experiment(16, layers=4,
   warm_start="marginals", warm_start_epochs=1000)``, 300 epochs in chunks
   of 100), the distillation's best TVD to the surrogate below its first
   epoch's and its 1000 epochs counted in kernels 1-2's launches;
   multiseed16 (``train_multi_seed`` on the 16-qubit workload, 4 seeds,
   HE L=2, 100 epochs), every loss finite and replica k equal to a
   one-seed run from its θ (1e-5 relative).
   sampled24 and sampled28 also report the per-variable posterior-marginal
   error at init and at the end (mean and max |Δp| against likelihood
   weighting with 2,000,000 samples, with its ESS; the model marginals from
   two axis reductions of the (R, C) probabilities, the FP32 reduction held
   to 1e-6 of a float64 one).
14. The command line, durable resume, checkpoints and the profiler
   (``tensornetworks_tpu_torch.runners.cli``, ``train/``) and the machine's
   state. cli16: bn16 at full width through ``cli.main`` (``scale --qubits
   16 --layers 8 --ansatz bn_structured --epochs 600 --lr 0.05
   --length-scale 0.0625 --chunk-epochs 100``), exactly 602/600/600/600
   launches of kernels 1, 2, 3 and stein_gcorr, its steady epochs/s; then
   killed after 3 chunks (the fault injected into the engine module's
   ``run_ksd_scan``) with ``--resume-state S --checkpoint B``, and resumed
   by ``python -m tensornetworks_tpu_torch.runners.cli`` in another
   process, which must exit 0 and remove S; the two checkpoints equal bit
   for bit. cli20: scale20 with ``--temper-betas 0.5,1.0``, killed after
   chunk 1 and resumed in process: history, θ, best θ, best TVD and epoch
   and checkpoints equal bit for bit. cli_adv16: the adversarial objective
   (bn_structured L=8) over two lr phases of 100 epochs, killed after phase
   2's first chunk and run again, under ``torch.use_deterministic_algorithms``
   in a process of its own (``chip_smoke.py --cli-adv16``, started with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, so that no other phase runs under
   either): phase 1 replays from ``S.phase0`` with no epoch dispatched, both
   snapshots go, the best Born and discriminator parameters equal the
   uninterrupted run's bit for bit. Snapshot write and load times are
   printed. profile16: main16's engine for 2 chunks of 25 epochs with
   ``profile_dir``; the trace must name the __global__ functions of kernels
   1, 2, 3 and stein_gcorr. state16/state20: ``QuantumBornMachine.state``
   (HE L=4) from kernel 1 and kernel 5: |state|² against ``probs`` (1e-6
   absolute and 1e-5 of the largest probability) and against the float64 blocked executor's state (1e-5 relative).
15. The distributed engines (``parallel/``, ``engines/distributed*.py``) on
   torch.distributed, one process a rank. NCCL runs one rank a card, so on
   one card it runs D=1; several ranks share the card over gloo, whose
   collectives stage through host memory (each row prints its transport).
   dist20: ``cli scale --qubits 20 --layers 4 --mesh 1 --epochs 60
   --chunk-epochs 20`` (nccl), scale20's configuration at full width:
   kernel 4 (stein2d_grid) exactly 60 times and the lean executor's shard
   passes (its circuit), epoch 0 within 1e-4 of float64,
   the loss history within 1e-3 (relative) of scale20's from the same θ0.
   dist20x4: the same with ``--mesh 4 --dist-backend gloo`` (2^18
   amplitudes a rank), kernel 4 60 times on every rank and the executor's
   pair combines beside its passes, the history within
   1e-4 of dist20's; then killed after its first chunk (every rank's engine
   module's ``run_ksd_scan`` raising, in ranks of this script) and resumed
   by the CLI with ``--resume-state``: history, θ, best θ, best TVD and
   epoch equal bit for bit, the snapshot gone. In one 4-rank gloo world:
   dist_sampled20x4, ``DistributedSampledKSDVariationalInference`` (HE L=4,
   512 shots, lr 0.05, 20 epochs, the TVD on the loss forward), the lean
   executor's passes and pair combines on every rank,
   against the single-device engine (kernel 5) at each epoch's θ of the
   ranks' run on the same uniforms: the shots equal but at FP32 CDF ties
   (within 1e-5 of the step; counted and printed), the U-statistics within
   1e-4 (two FP32 circuits drift apart over the epochs, so the two engines
   run free would part at their first tie);
   amortized_mesh16x4, amortized16's model over dp=4 for 200 epochs, and
   multiseed_mesh16x4, multiseed16 over dp=4: losses and (mean) TVDs within
   rtol 1e-4 and atol 5e-4 of the single-device runs, every rank launching
   kernels 1-3 and stein_gcorr a quarter of their counts. In each rank the
   launch and collective byte counts start at 0 with the phase; every
   rank's are read after it, with its peak device memory, and θ must be
   equal bit for bit on every rank.
16. The precision policy (``ops/kernels/precision.py``, the engines'
   ``highest_matmul_precision``), every phase above having run at the
   defaults. precision_kernels: kernels 1-2 at n=16 (HE L=4; bn_structured
   L=8) and kernels 5-6 at n=20 (HE L=4) and n=24 (bn_structured L=8, one
   timed call each), each under ``default`` and ``high`` (bf16 tensor-core
   variants, counted under ``<kernel>.<precision>``), held against the plain
   emulation of the same passes on the card and against float64 without
   rounding; printed beside the FP32 kernel's time and a bound at the bf16
   tensor-core peak; kernels 1-2 (kernel 2's bf16 variants are the kernel of
   ``csrc/circuit_bf16.cuh``, whose launch plan must equal its CPU mirror's
   ``bf16_plan`` at n = 2..17) untimed at n = 2, 3 (with and without the
   wall), 5, 15, 16 (no wall) and 17, kernels 5-6 at n = 18, 19, 21 and 22,
   each against the emulation and float64, kernels 1-2 also three calls bit
   for bit. wgmma_products: each of
   the six product patterns of kernels 5-6 (``PRODUCT_PATTERNS``: the
   pull-backs at batch 2, dMc, dMr, the forward's left product and its
   scatter epilogue with |C|^2) alone on the Hopper loop of
   ``csrc/wgmma_bf16.cuh`` at n = 20 and 24 under ``high`` and
   ``default``, against its plain extended-K emulation and float64, timed
   against its bound and against ``torch.matmul`` on bf16 planes of the
   same shapes (4 real GEMMs a pass).
   precision16: ``runners/bench_precision.py``'s two
   configurations (the 3-qubit Sprinkler oracle; the 16-qubit chain,
   bn_structured L=8, 800 epochs) under ``highest``, ``high`` and
   ``default`` with both knobs, and ``high`` and ``default`` with the kernel
   knob alone: Sprinkler's best TVD ≤ 0.01 under ``highest`` and ``high``;
   the rest printed. exact24_high: exact24 under the kernel precision
   ``high``, its loss history within 1e-3 (relative) of exact24's;
   grid20_default: scale20's configuration for 20 epochs under the kernel
   precision ``default`` (the path of kernels 5-6's ``default`` variants);
   on both, every bf16 product of kernels 5-6 on the wgmma loop (the
   library's host counts by loop, ``bf16_product_counts``), none on the
   mma.sync passes;
   sampled28_tf32: sampled28 on the blocked adjoint executor
   (``qbm_grad_method="adjoint"``) under ``TNTPU_MATMUL_PRECISION=default``
   (its cuBLAS GEMMs in TF32), its U-statistics' gap to sampled28's printed.

Prints each phase's seconds, a ``{"kernels": [...]}`` line (each kernel
with the launch count of the path that runs it, and its launches on every
path that runs it), a ``{"bn_structured": [...]}`` line (the timed
bn_structured checks and each bn path's launches), a ``{"large_n": [...]}``
line (the timed checks at the wide shapes of step 10, with the exact paths'
launches), a ``{"sampled": [...]}`` line (step 12's paths: epochs/s or
samples/s, launches, first and last U-statistic, best TVD, peak memory),
an ``{"amortized": [...]}`` line (step 13's checks and paths: errors,
epochs/s, launches, TVDs), a ``{"cli": [...]}`` line (step 14's paths:
epochs/s, launches, snapshot bytes and ms, the trace's kernels, the state's
errors), a ``{"distributed": [...]}`` line (step 15's paths: transport,
epochs/s, each rank's launches, peak memory and collective bytes an epoch,
the checks' errors), a ``{"precision": [...]}`` line (step 16's checks and
paths) and, last, the ``{"ok": true, ...}`` line. The ``kernels`` line
lists the bf16 variants that ran beside the FP32 kernels. Imports nothing
of JAX or of the JAX package.
"""

import contextlib
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

# Published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, dense bf16 on the tensor cores, and HBM3 bandwidth. At the default
# precision the port runs FP32 FMA only (no TF32); the circuit kernels'
# `high` and `default` variants run bf16 passes on the tensor cores.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
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
# Sampled KSD (ROADMAP A9), 1024 shots a step. sampled16:
# scripts/quality_sampled.py's defaults (bn_structured L=8, ℓ auto = 1/16,
# loo, eval on the loss forward, seed 0), one phase of 2000 epochs at lr
# 0.05 in chunks of 500; its limit is the JAX package's best TVD for the same
# configuration in float32 on a CPU (0.33152 at epoch 1897, 131 s on 8 CPU
# cores; scripts/jax_reference_tvd.py sampled16) + 0.1, a margin for the
# port's other shots. sampled24: examples/sampled_ksd_large_n.py (a random
# chain network of 26 variables, seed 11, V24=1 and V25=0 observed; HE L=4,
# lr 0.05, two-stage shots, the TVD against the exact posterior on a second
# forward), cut from 300 epochs to 20. sampled28: scripts/probe_sampled_28.py
# (29 variables, seed 11, V28=1; HE L=4, ℓ = 1, lr 0.05, no TVD), cut from 60
# epochs to 6. sampling20: run_sampling_throughput at its defaults.
SHOTS = 1024
SAMPLED16_EPOCHS, SAMPLED16_CHUNK = 2000, 500
SAMPLED16_JAX_TVD = 0.33152
SAMPLED16_TVD_MAX = SAMPLED16_JAX_TVD + 0.1
N_SAMPLED24, SAMPLED24_EPOCHS, SAMPLED24_CHUNK = 24, 20, 10
N_SAMPLED28, SAMPLED28_EPOCHS, SAMPLED28_CHUNK = 28, 6, 3
N_SAMPLING, SAMPLING_LAYERS, SAMPLING_SHOTS = 20, 2, 65536
# Amortized inference (ROADMAP A10). amortized16: scripts/quality_amortized16.py's
# model (18 variables, seed 0, V16 and V17 observed: 4 observations;
# bn_structured L=8 re-uploading the fixed wall, ℓ auto = 1/16, clip 10,
# entropy 0, seed 0), one phase of 2000 epochs at lr 0.05 in chunks of 500;
# its limit is the JAX package's best mean TVD for the same configuration
# in float32 on a CPU (0.11213 at epoch 547, from 0.82093 after epoch 0;
# 558 s on 8 CPU cores; scripts/jax_reference_tvd.py amortized16) + 0.1, a
# margin for the port's other θ init. amortized20: run_amortized_experiment
# (20, quantum=True, hardware_efficient, L=4) for 20 epochs in chunks of 10.
# warm16: run_scale_experiment(16, L=4, warm_start="marginals") with a
# 1000-epoch distillation, then 300 KSD epochs in chunks of 100.
# multiseed16: train_multi_seed on the 16-qubit workload, 4 seeds, HE L=2,
# 100 epochs.
N_COND_GRID = 20
COND_D, COND_X = 2, (1.0, 1.0)
AMORTIZED16_EPOCHS, AMORTIZED16_CHUNK, AMORTIZED16_LR = 2000, 500, 0.05
AMORTIZED16_JAX_TVD = 0.11213
AMORTIZED16_TVD_MAX = AMORTIZED16_JAX_TVD + 0.1
AMORTIZED20_EPOCHS, AMORTIZED20_CHUNK = 20, 10
WARM16_LAYERS, WARM16_EPOCHS, WARM16_DISTILL_EPOCHS, WARM16_CHUNK = 4, 300, 1000, 100
MULTISEED_SEEDS, MULTISEED_LAYERS, MULTISEED_EPOCHS = 4, 2, 100
MULTISEED_TOL = 1e-5
# The command line, durable resume and checkpoints (ROADMAP A11), through
# ``tensornetworks_tpu_torch.runners.cli``. cli16: bn16's configuration at
# full width, 600 epochs in chunks of 100, killed after 3 chunks and resumed
# by the CLI in another process; cli20: scale20 with the tempered target
# (β 0.5 then 1.0), killed after chunk 1 and resumed in process; cli_adv16:
# adversarial16's model over two lr phases of 100 epochs in chunks of 50,
# killed after phase 2's first chunk and run again. Every resumed result
# must equal the uninterrupted one bit for bit. profile16: main16's engine
# for 2 chunks of 25 epochs under the profiler. state16/state20: the
# machine's state (HE L=4) through kernels 1 and 5.
CLI16_ARGV = ["scale", "--qubits", "16", "--layers", "8", "--ansatz", "bn_structured",
              "--epochs", "600", "--lr", "0.05", "--length-scale", "0.0625",
              "--chunk-epochs", "100"]
CLI16_EPOCHS, CLI16_KILL = 600, 3
CLI20_ARGV = ["scale", "--qubits", "20", "--layers", "4", "--epochs", "60",
              "--chunk-epochs", "20", "--temper-betas", "0.5,1.0"]
CLI20_KILL = 1
CLI_ADV16_ARGV = ["scale", "--qubits", "16", "--objective", "adversarial", "--ansatz",
                  "bn_structured", "--layers", "8", "--lr-phases", "100:0.003,100:0.001",
                  "--chunk-epochs", "50"]
CLI_ADV16_PHASE_EPOCHS, CLI_ADV16_CHUNK = 100, 50
PROFILE16_EPOCHS, PROFILE16_CHUNK = 50, 25
# The __global__ functions of kernels 1, 2, 3 (n=16 runs the cluster
# butterfly) and stein_gcorr, as the profiler's trace names them.
PROFILE16_KERNELS = ("circuit2d_fwd_kernel", "circuit2d_bwd_kernel", "cluster_butterfly_kernel",
                     "gcorr_combine_kernel")
# |state|² against probs: absolute, and relative to the largest probability
# (at n = 20 a probability is ~1e-6, so the absolute limit alone holds little).
STATE_TOL_PROBS, STATE_TOL_PROBS_REL, STATE_TOL_F64 = 1e-6, 1e-5, 1e-5
# The wide sampled paths' quality report: per-variable posterior marginals
# against likelihood weighting (scripts/quality28_sampled.py's measure).
LW_SAMPLES = 2_000_000
MARGINAL_REDUCTION_TOL = 1e-6
# An index drawn on the card may differ from the float64 draw on the same
# uniform only at a rounding tie: the uniform within this much of the CDF
# step it crossed (the CDFs are FP32 sums, the total 1).
TIE_DISTANCE = 1e-6
# stein_gram_samples in FP32 against float64 on the same samples and scores:
# on the CPU it read 1.8e-7 of max |K_p| at n=24, M=1024 (ℓ = 1 and 1/n).
GRAM_TOL = 1e-5
# The blocked adjoint (complex64 block matmuls) against the grid kernels:
# on the CPU each read about 3e-6 of the largest probability and gradient
# component against float64 at n=20, so their difference gets the grid
# kernels' own margins against their plain version (2e-5 and 2e-4) from
# n=20 on, and twice the forward's at n=24.
BLOCKED_TOL = {"fwd": 4e-5, "bwd": 2e-4}
# The blocked CDF scan (sim.sampling.blocked_cumsum) of a normalised 2^24 q
# in FP32 against float64's cumsum of the same values: three levels of
# 1024-long rows, each partial sum ≤ 1, bound about 4e-6 in all (absolute);
# and the log-q gather's gradient (SHOTS shots on 16 states, about 64 FP32
# terms a state) against float64's index_add_, relative to its largest.
CDF_TOL, GATHER_TOL = 1e-5, 1e-5

# The distributed engines (ROADMAP A12) on torch.distributed, one process a
# rank (tensornetworks_tpu_torch.parallel.launch.spawn). NCCL runs one rank a
# card, so one card runs it at D=1; gloo runs several ranks on the one card,
# its collectives staged through host memory. dist20: scale20's configuration
# through ``cli scale --mesh 1`` (nccl); dist20x4: the same with ``--mesh 4
# --dist-backend gloo`` (2^18 amplitudes a rank), then killed after its
# first chunk and resumed by the CLI; dist_sampled20x4: the distributed
# sampled engine (HE L=4, 512 shots, lr 0.05, 20 epochs) on 4 gloo ranks
# against the single-device engine on the same uniforms;
# amortized_mesh16x4 and multiseed_mesh16x4: amortized16's model (200
# epochs) and multiseed16 (4 seeds, 100 epochs) over dp=4, against their
# single-device runs (the JAX spec's tolerances for the seeds, rtol 1e-4 and
# atol 5e-4, for both).
DIST_RANKS = 4
# The lean distributed executor's kernels (ops/kernels/shard_gates.py) at a
# rank's shape in the sampled_he4.n32x4 cell: n=32 on four ranks (30 local
# bits, rank 3, whose layer store carries a constant XOR and sign), pieces
# of 2^26 amplitudes at the shard's last offset; SHARD_BLOCKS tiles of each
# wide pass against the plain version (the whole pass's index tables do not
# fit beside the state).
N_SHARD, SHARD_RANKS, SHARD_PIECE, SHARD_BLOCKS = 32, 4, 1 << 26, 64
DIST20_ARGV = ["scale", "--qubits", "20", "--layers", "4", "--epochs", "60",
               "--chunk-epochs", "20"]
DIST20_EPOCHS, DIST20_CHUNK, DIST20_KILL = 60, 20, 1
DIST20_TOL, DIST20X4_TOL = 1e-3, 1e-4
DIST_SAMPLED_SHOTS, DIST_SAMPLED_EPOCHS, DIST_SAMPLED_LR, DIST_SAMPLED_TOL = 512, 20, 0.05, 1e-4
# dist_sampled20x4 against the single-device engine at each epoch's θ of the
# ranks' run (the two FP32 circuits' trajectories drift apart, and so would
# their shots): a shot may differ only where its uniform lies within this
# much of the CDF step it crossed, the grid forward's margin against its
# plain version (2e-5 of the largest probability) carried into CDF steps.
DIST_TIE_DISTANCE = 1e-5
AMORTIZED_MESH_EPOCHS, MULTISEED_MESH_EPOCHS = 200, 100
MESH_RTOL, MESH_ATOL = 1e-4, 5e-4
DIST_TIMEOUT_S = 600

# The precision policy (ROADMAP A14). precision_kernels' cases (n, grid,
# ansatz, L): kernels 1-2 at main16's and bn16's shapes, kernels 5-6 at
# scale20's and exact24's. Limits of a bf16 variant, relative to the largest
# magnitude: `default` against its plain emulation 2e-2 (one flipped bf16
# rounding of an accumulated state carries on to later layers); `high`
# against its plain emulation and against float64 1e-4: a split operand
# keeps about 16 bits (2^-17 ≈ 7.6e-6 relative), and any FP32-order
# difference between kernel and emulation can move a split, so the two agree
# to about the emulation's own distance from float64 (on the card 1.8e-5 to
# 3.7e-5 at these shapes, the kernels 1.2e-5 to 3.5e-5; PERF.md).
PRECISION_CASES = ((N, False, ANSATZ, LAYERS), (N, False, BN, BN_LAYERS),
                   (N_GRID, True, ANSATZ, LAYERS), (N_EXACT24, True, BN, BN_LAYERS))
PRECISION_TOL = {"high": 1e-4, "default": 2e-2}
# The float64 limit under `high` where it is not PRECISION_TOL's, by (n,
# ansatz) of kernels 1-2: n=3 basic L=4, where the plain emulation of the
# three passes is itself 1.29e-4 from float64 (and the kernels the same) on
# the H100, so that no `high` kernel can come within 1e-4 there.
PRECISION_F64_TOL_HIGH = {(N_RAGGED, "basic"): 2e-4}
# Kernels 1-2's bf16 variants untimed beside PRECISION_CASES (n, ansatz): the
# smallest state, ragged n=3 with and without the wall (basic), n=5 (the
# backward's element path below n = 10), odd n=15 (R = 2C), n=16 without the
# wall (the backward's TMA path on a state of one nonzero column) and n=17
# (the looped items), each against its emulation and float64 and repeated
# bit for bit.
BF16_CIRCUIT_CASES = ((N_MIN, ANSATZ), (N_RAGGED, ANSATZ), (N_RAGGED, "basic"),
                      (N_NO_WALL, ANSATZ), (N_ODD, ANSATZ), (N, "basic"), (N_MAX, ANSATZ))
BF16_REPEATS = 3
PASSES = {"high": 3, "default": 1}
PRECISION_VARIANTS = tuple(f"{k}.{p}" for k in ("circuit2d_fwd", "circuit2d_bwd",
                                                 "circuit2d_grid_fwd", "circuit2d_grid_bwd")
                           for p in ("high", "default"))
# The path each variant's launches are read on, and the check whose shape
# matches it (n, ansatz): precision16's chain is bn16's shape, exact24_high
# exact24's, grid20_default scale20's.
VARIANT_PATH = {v: ("precision16", (N, BN)) if not v.startswith("circuit2d_grid")
                else ("exact24_high", (N_EXACT24, BN)) if v.endswith("high")
                else ("grid20_default", (N_GRID, ANSATZ)) for v in PRECISION_VARIANTS}
GRID20_DEFAULT_EPOCHS, GRID20_DEFAULT_CHUNK = 20, 10
# exact24_high's loss history against exact24's (FP32), relative: the
# variant's products keep about 16 bits; the FP32 gap reads about 1e-5
# (PERF.md).
EXACT24_HIGH_GAP_MAX = 1e-3
# wgmma_products: the shapes (n) of each product pattern alone.
WGMMA_PRODUCT_NS = (N_GRID, N_EXACT24)
# The FP32 runs that exact24_high and sampled28_tf32 are compared with.
REFERENCE_RUNS = {}

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
# The gate path of kernels 5-6 (csrc/circuit_gates.cu) rounds once per gate
# and amplitude against a plain version of the same tiles and gate order,
# and keeps the grid pair's margins. Past 24 qubits it has no plain version
# on the card: its θ-gradient of a loss on 1024 shots is held against the
# blocked adjoint executor's (complex64) at 3e-5, 4.8x the 6.3e-6 read at
# n=28 (tests/test_torch_circuit_gates_chip.py's TOL_GRAD_WIDE).
# The shard's passes (gates_pass_*) hold the gate path's one-pass margins
# against a float64 plain version on sampled tiles; the backward's also
# bound each tile's dU record. A pair combine rounds a few times an element
# (2e-6); its dU row and gates_reduce sum records of 4096 elements in FP32.
TOL = {"circuit2d_fwd": 1e-5, "circuit2d_bwd": 1e-4, "stein2d": 1e-5,
       "circuit2d_grid_fwd": 2e-5, "circuit2d_grid_bwd": 2e-4, "stein2d_grid": 1e-5,
       "stein_gcorr": 1e-5, "circuit_gates_fwd": 2e-5, "circuit_gates_bwd": 2e-4,
       "circuit_gates_wide_grad": 3e-5,
       "gates_pass_fwd": 1e-5, "gates_pass_bwd": 1e-4, "gates_reduce": 1e-5,
       "pair_fwd": 2e-6, "pair_bwd": 1e-5}

REPLACES = {
    "circuit2d_fwd": "tensornetworks_tpu/ops/pallas/circuit2d.py:185",
    "circuit2d_bwd": "tensornetworks_tpu/ops/pallas/circuit2d.py:227",
    "stein2d": "tensornetworks_tpu/ops/pallas/stein2d.py:45",
    "stein2d_grid": "tensornetworks_tpu/ops/pallas/stein2d.py:121",
    "circuit2d_grid_fwd": "tensornetworks_tpu/ops/pallas/circuit2d_grid.py:150",
    "circuit2d_grid_bwd": "tensornetworks_tpu/ops/pallas/circuit2d_grid.py:187",
    "circuit_gates_fwd": "tensornetworks_tpu/ops/pallas/circuit2d_grid.py:150",
    "circuit_gates_bwd": "tensornetworks_tpu/ops/pallas/circuit2d_grid.py:187",
    # No Pallas kernel: the XLA correction step of stein_matvec_gcorr_tables.
    "stein_gcorr": "tensornetworks_tpu/ops/stein.py:406",
    # The sharded state's gates: XLA, local bits in place, global bits by ppermute.
    "gates_pass_fwd": "tensornetworks_tpu/parallel/shard_state.py:39",
    "gates_pass_bwd": "tensornetworks_tpu/parallel/shard_state.py:39",
    "gates_reduce": "tensornetworks_tpu/parallel/shard_state.py:39",
    "pair_fwd": "tensornetworks_tpu/parallel/shard_state.py:64",
    "pair_bwd": "tensornetworks_tpu/parallel/shard_state.py:64",
}
# The bf16 variants of kernel 2 are the kernel of their own source (entered
# through circuit2d.cu).
VARIANT_SOURCES = {"circuit2d_bwd": "tensornetworks_tpu_torch/csrc/circuit_bf16.cuh"}
SOURCES = {
    "circuit2d_fwd": "tensornetworks_tpu_torch/csrc/circuit2d.cu",
    "circuit2d_bwd": "tensornetworks_tpu_torch/csrc/circuit2d.cu",
    "stein2d": "tensornetworks_tpu_torch/csrc/stein2d.cu",
    "stein2d_grid": "tensornetworks_tpu_torch/csrc/stein2d.cu",
    "circuit2d_grid_fwd": "tensornetworks_tpu_torch/csrc/circuit2d_grid.cu",
    "circuit2d_grid_bwd": "tensornetworks_tpu_torch/csrc/circuit2d_grid.cu",
    "stein_gcorr": "tensornetworks_tpu_torch/csrc/stein_gcorr.cu",
    "circuit_gates_fwd": "tensornetworks_tpu_torch/csrc/circuit_gates.cu",
    "circuit_gates_bwd": "tensornetworks_tpu_torch/csrc/circuit_gates.cu",
    "gates_pass_fwd": "tensornetworks_tpu_torch/csrc/circuit_gates.cu",
    "gates_pass_bwd": "tensornetworks_tpu_torch/csrc/circuit_gates.cu",
    "gates_reduce": "tensornetworks_tpu_torch/csrc/circuit_gates.cu",
    "pair_fwd": "tensornetworks_tpu_torch/csrc/circuit_gates.cu",
    "pair_bwd": "tensornetworks_tpu_torch/csrc/circuit_gates.cu",
}
# The kernels each path must launch; it must launch no other kernel. The
# bn_structured and exact paths run exactly the kernel sets of main16 and
# scale20. From 18 qubits the FP32 paths run kernels 5-6 as the gate path
# (circuit_gates_*); the dense-operator kernels (circuit2d_grid_*) run their
# bf16 variants on exact24_high and grid20_default, and in FP32 only in the
# kernel checks.
SHARD_PASSES = ("gates_pass_fwd", "gates_pass_bwd", "gates_reduce")
PAIR_COMBINES = ("pair_fwd", "pair_bwd")
PATH_KERNELS = {
    "main16": ("circuit2d_fwd", "circuit2d_bwd", "stein2d", "stein_gcorr"),
    "scale20": ("circuit_gates_fwd", "circuit_gates_bwd", "stein2d_grid", "stein_gcorr"),
}
PATH_KERNELS.update(bn16=PATH_KERNELS["main16"], bn20=PATH_KERNELS["scale20"],
                    sprinkler_classical=(), classical16=("stein2d", "stein_gcorr"),
                    classical20=("stein2d_grid", "stein_gcorr"), sprinkler_adversarial=(),
                    adversarial16=("circuit2d_fwd", "circuit2d_bwd"),
                    exact22=PATH_KERNELS["scale20"], exact24=PATH_KERNELS["scale20"],
                    sampled16=("circuit2d_fwd", "circuit2d_bwd"),
                    sampled24=("circuit_gates_fwd", "circuit_gates_bwd"),
                    sampled28=("circuit_gates_fwd", "circuit_gates_bwd"),
                    sampling20=("circuit_gates_fwd",),
                    amortized16=PATH_KERNELS["main16"], amortized20=PATH_KERNELS["scale20"],
                    warm16=PATH_KERNELS["main16"], multiseed16=PATH_KERNELS["main16"],
                    cli16=PATH_KERNELS["main16"], cli20=PATH_KERNELS["scale20"],
                    cli_adv16=("circuit2d_fwd", "circuit2d_bwd"),
                    profile16=PATH_KERNELS["main16"], state16=("circuit2d_fwd",),
                    state20=("circuit_gates_fwd",),
                    # On every rank: the distributed Stein matvec's local apply
                    # (20 and 18 local bits: kernel 4); the lean executor's
                    # shard passes, and on more than one rank its pair
                    # combines; the dp ranks run amortized16's and multiseed16's.
                    dist20=("stein2d_grid",) + SHARD_PASSES,
                    dist20x4=("stein2d_grid",) + SHARD_PASSES + PAIR_COMBINES,
                    dist_sampled20x4=SHARD_PASSES + PAIR_COMBINES,
                    amortized_mesh16x4=PATH_KERNELS["main16"],
                    multiseed_mesh16x4=PATH_KERNELS["main16"],
                    exact24_high=("circuit2d_grid_fwd.high", "circuit2d_grid_bwd.high",
                                  "stein2d_grid", "stein_gcorr"),
                    grid20_default=("circuit2d_grid_fwd.default", "circuit2d_grid_bwd.default",
                                    "stein2d_grid", "stein_gcorr"),
                    sampled28_tf32=(),
                    precision16=("circuit2d_fwd", "circuit2d_bwd", "circuit2d_fwd.high",
                                 "circuit2d_bwd.high", "circuit2d_fwd.default",
                                 "circuit2d_bwd.default", "stein2d", "stein_gcorr"))


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


def gate_bounds(plan):
    """(forward, backward) bounds of the gate path's kernels: each pass
    reads and writes the state's two planes (the backward's four), each
    gate is 14 FLOPs an amplitude (the backward's two pulls and dU's sums,
    44)."""
    passes, size = len(plan.gate_passes()), 1 << plan.n
    gates = plan.n * plan.layers * size
    return (bound(14 * gates + 3 * size, passes * 2 * 2 * 4 * size),
            bound(44 * gates + 2 * size, passes * 4 * 2 * 4 * size))


def check_gates(plan, theta, g, timing):
    """The gate path's kernels (kernels 5-6 under ``highest``) against
    their plain version on the card, on the grid check's θ and cotangent;
    each bit-equal over two runs. Timed records where ``timing``."""
    import torch
    from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg
    from tensornetworks_tpu_torch.sim.gates import layer_rotations

    U = layer_rotations(theta, plan.n, plan.layers, plan.per_qubit)
    out_k = kg.circuit_gates_forward(U, plan)
    out_p = kg.circuit_gates_forward_plain(U, plan)
    again = kg.circuit_gates_forward(U, plan)
    dU_k = kg.circuit_gates_backward(U, out_k[1], out_k[2], g, plan)
    dU_p = kg.circuit_gates_backward_plain(U, out_p[1], out_p[2], g, plan)
    dU_again = kg.circuit_gates_backward(U, out_k[1], out_k[2], g, plan)
    torch.cuda.synchronize()
    what = f"circuit_gates n={plan.n} L={plan.layers} {plan.ansatz_type}"
    require(all(torch.equal(a, b) for a, b in zip(out_k, again)) and torch.equal(dU_k, dU_again),
            f"{what}: two runs differ")
    fwd_err = max(rel_err(a, b) for a, b in zip(out_k, out_p))
    dU_k, dU_p = torch.view_as_real(dU_k), torch.view_as_real(dU_p)
    bwd_err = rel_err(dU_k, dU_p)
    require(fwd_err <= TOL["circuit_gates_fwd"], f"{what}: forward rel err {fwd_err:.3e}")
    require(bwd_err <= TOL["circuit_gates_bwd"], f"{what}: backward rel err {bwd_err:.3e}")
    abs_fwd = float((out_k[0] - out_p[0]).abs().max())
    abs_bwd = float((dU_k - dU_p).abs().max())
    print(f"{what}: {len(plan.gate_passes())} passes, fwd rel {fwd_err:.2e}, dU rel "
          f"{bwd_err:.2e}, bit-equal over two runs", flush=True)
    if not timing:
        return []
    fwd_bound, bwd_bound = gate_bounds(plan)
    t = timer(plan.n)
    return [
        dict(name="circuit_gates_fwd", max_abs_err=abs_fwd, rel_err=fwd_err,
             ms=t(lambda: kg.circuit_gates_forward(U, plan)),
             plain_ms=t(lambda: kg.circuit_gates_forward_plain(U, plan)),
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=None),
        dict(name="circuit_gates_bwd", max_abs_err=abs_bwd, rel_err=bwd_err,
             ms=t(lambda: kg.circuit_gates_backward(U, out_k[1], out_k[2], g, plan)),
             plain_ms=t(lambda: kg.circuit_gates_backward_plain(U, out_p[1], out_p[2], g, plan)),
             bound_ms=bwd_bound[0], bound_by=bwd_bound[1], library_ms=None),
    ]


def check_wide_gates(n, device):
    """The gate path's kernels past the dense path's 24 qubits, at
    sampled28's shape (HE L=4, θ 0.1·N(0, 1)): forward and dU bit-equal
    over two runs, the probabilities against the blocked executor's
    (complex64, cuBLAS; its forward's time as ``library_ms``), and the
    θ-gradient of a REINFORCE-like loss on 1024 shots, Σ c·log q(shot),
    through the machine ``auto`` builds (both kernels) against the blocked
    adjoint executor's, timed. No plain version: its index tables of a 2^28
    pass take tens of GiB (float64 is ``tests/test_torch_circuit_gates_chip.py``'s).
    Returns the records."""
    import numpy as np
    import torch
    from tensornetworks_tpu_torch.models import QuantumBornMachine
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg
    from tensornetworks_tpu_torch.sim.gates import layer_rotations

    plan = kg.GridPlan(n, LAYERS, ANSATZ, precision="highest")
    gen = torch.Generator().manual_seed(n)
    theta = (0.1 * torch.randn(plan.per_qubit * n * LAYERS, generator=gen)).to(device)
    U = layer_rotations(theta, n, LAYERS, plan.per_qubit)
    g = torch.randn((plan.R, plan.C), generator=gen).to(device)
    out = kg.circuit_gates_forward(U, plan)
    again = kg.circuit_gates_forward(U, plan)
    require(all(torch.equal(a, b) for a, b in zip(out, again)), f"circuit_gates n={n}: two "
            f"forward runs differ")
    del again
    dU = kg.circuit_gates_backward(U, out[1], out[2], g, plan)
    require(torch.equal(dU, kg.circuit_gates_backward(U, out[1], out[2], g, plan)),
            f"circuit_gates n={n}: two backward runs differ")
    del dU
    rng = np.random.default_rng(n)
    shots = torch.as_tensor(np.sort(rng.choice(1 << n, size=SHOTS, replace=False)), device=device)
    coef = torch.as_tensor(1e-3 * rng.normal(size=SHOTS), dtype=torch.float32, device=device)

    def shot_grad(bm):
        p = theta.clone().requires_grad_(True)
        q = bm.probs(p)
        return q.detach(), torch.autograd.grad((coef * torch.log(q[shots])).sum(), p)[0]

    gates = QuantumBornMachine(n, LAYERS, ANSATZ, device=device)
    require((gates.backend, gates.grad_method) == ("circuit2d_grid", "autodiff"),
            f"circuit_gates n={n}: auto builds {gates.backend}/{gates.grad_method}")
    before = dict(kernels.LAUNCHES)
    q, dtheta = shot_grad(gates)
    launched = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()
                if v != before.get(k, 0)}
    require(launched == {"circuit_gates_fwd": 1, "circuit_gates_bwd": 1},
            f"circuit_gates n={n}: the machine's step launched {launched}")
    q = q.cpu()
    del gates
    blocked = QuantumBornMachine(n, LAYERS, ANSATZ, backend="blocked", grad_method="adjoint",
                                 device=device)
    q_b, dtheta_b = shot_grad(blocked)
    q_b = q_b.cpu()
    fwd_err, abs_fwd = rel_err(q, q_b), float((q - q_b).abs().max())
    grad_err, abs_grad = rel_err(dtheta, dtheta_b), float((dtheta - dtheta_b).abs().max())
    require(fwd_err <= TOL["circuit_gates_fwd"], f"circuit_gates n={n}: probs vs the blocked "
            f"executor rel err {fwd_err:.3e}")
    require(grad_err <= TOL["circuit_gates_wide_grad"], f"circuit_gates n={n}: θ-gradient vs the "
            f"blocked adjoint rel err {grad_err:.3e}")
    del q, q_b
    t = timer(n)
    with torch.no_grad():
        library_ms = t(lambda: blocked.probs(theta))
    del blocked
    fwd_bound, bwd_bound = gate_bounds(plan)
    records = [
        dict(name="circuit_gates_fwd", n=n, max_abs_err=abs_fwd, rel_err=fwd_err,
             ms=t(lambda: kg.circuit_gates_forward(U, plan)), plain_ms=None,
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=library_ms),
        dict(name="circuit_gates_bwd", n=n, max_abs_err=abs_grad, rel_err=grad_err,
             ms=t(lambda: kg.circuit_gates_backward(U, out[1], out[2], g, plan)), plain_ms=None,
             bound_ms=bwd_bound[0], bound_by=bwd_bound[1], library_ms=None)]
    print(f"circuit_gates n={n} L={LAYERS} {ANSATZ}: {len(plan.gate_passes())} passes, probs vs "
          f"the blocked executor rel {fwd_err:.2e}, θ-gradient vs the blocked adjoint rel "
          f"{grad_err:.2e}, bit-equal over two runs; forward {records[0]['ms']:.3f} ms (blocked "
          f"executor {library_ms:.3f}), backward {records[1]['ms']:.3f} ms; bounds "
          f"{fwd_bound[0]:.3f} / {bwd_bound[0]:.3f} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return records


def _planes_at(planes, idx):
    """The complex128 amplitudes of the planes (2, P) at idx."""
    import torch

    return torch.complex(planes[0][idx].double(), planes[1][idx].double())


def _shard_pass_plain(ps, U, x, blocks):
    """(dst, vals) of a shard pass's forward on ``blocks`` in float64: the
    tiles loaded from the planes x, the pass's gates, the store's map and
    sign (``gate_pass_forward_plain`` restricted to those tiles)."""
    from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg

    src, dst, pos = kg.gate_pass_index(ps, x.device, blocks)
    tile = _planes_at(x, src)
    for t, q in ps.gates:
        tile = kg._apply_gate(tile, t, U[ps.layer, q])
    vals = tile.gather(1, pos)
    if ps.cz is not None or ps.negate:
        vals = vals * kg._store_sign(ps, dst, vals.real.dtype)
    return dst, vals


def _shard_adjoint_plain(ps, Uh, x, lam, blocks):
    """(src, x, λ, records) of a shard pass's adjoint on ``blocks`` in
    float64 (``gate_pass_backward_plain`` restricted to those tiles): x and
    λ un-computed at src, and each gate's dU record of each tile, {qubit:
    (B, 2, 2)}."""
    import torch
    from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg

    src, dst, pos = kg.gate_pass_index(ps, x.device, blocks)
    if not ps.map:
        dst, pos = src, torch.arange(src.shape[1], device=x.device).expand_as(src)
    s = kg._store_sign(ps, dst, torch.float64)
    tiles = []
    for v in (x, lam):
        t = torch.empty(src.shape, dtype=torch.complex128, device=x.device)
        t.scatter_(1, pos, s * _planes_at(v, dst))
        tiles.append(t)
    tx, tl = tiles
    records = {}
    for t, q in reversed(ps.gates):
        tx = kg._apply_gate(tx, t, Uh[ps.layer, q])
        vx, vl = kg._pair_view(tx, t), kg._pair_view(tl, t)
        records[q] = torch.stack([torch.stack([(vl[:, :, r] * vx[:, :, c].conj()).sum(dim=(1, 2))
                                               for c in (0, 1)], dim=-1) for r in (0, 1)], dim=-2)
        tl = kg._apply_gate(tl, t, Uh[ps.layer, q])
    return src, tx, tl, records


def _rel64(got, want):
    """max |got - want| / max |want| of complex or real tensors, in float64."""
    import torch

    got, want = torch.view_as_real(got) if got.is_complex() else got, \
        torch.view_as_real(want) if want.is_complex() else want
    return rel_err(got.double(), want.double())


def check_shard_passes(device, timing=True):
    """The lean executor's shard passes on the card at the n=32 cell's rank
    shape (30 local bits, rank 3 of 4, one HE layer), each pass against its
    float64 plain version on SHARD_BLOCKS tiles (the first, the last and
    random ones): the forward (map passes out of place, the others in place,
    as the executor runs them); the adjoint from the pass's output and a
    random λ (a map pass as the map undone on x and on λ alone, then its
    gates in place), x and λ un-computed and each tile's dU record of each
    gate; x un-computed against the pass's input; then ``gates_reduce`` on
    the records against their float64 sums. Timed: the layer's forward and
    adjoint passes, and the reduce."""
    import torch
    from tensornetworks_tpu_torch.ops.kernels import shard_gates as sg
    from tensornetworks_tpu_torch.parallel.distributed_ansatz import ShardProgram
    from tensornetworks_tpu_torch.sim.gates import layer_rotations

    k = SHARD_RANKS.bit_length() - 1
    prog = ShardProgram(N_SHARD, 1, ANSATZ, k, SHARD_RANKS - 1)
    tables, slots = prog.tables(device)
    t, nl = tables[0], prog.nl
    require(t.passes[-1].map and t.passes[-1].xor and t.passes[-1].cz is not None,
            "shard plan: rank 3's last pass lacks its map, XOR or CZ sign")
    gen = torch.Generator().manual_seed(0)
    theta = torch.rand(3 * N_SHARD, generator=gen, dtype=torch.float64) * 2 * math.pi
    U = layer_rotations(theta.to(torch.float32), N_SHARD, 1, 3)[:, k:].contiguous().to(device)
    U64 = U.to(torch.complex128)
    Uh = U64.conj().transpose(-1, -2)
    size = 1 << nl
    dgen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((2, size), generator=dgen, device=device)
    lam = torch.randn((2, size), generator=dgen, device=device)
    y, bx, bl = (torch.empty_like(x) for _ in range(3))
    partials = torch.full((prog.records[0], 8), float("nan"), device=device)
    fwd_err = bwd_err = 0.0
    abs_fwd = abs_bwd = 0.0
    for i, ps in enumerate(t.passes):
        if ps.map:
            sg.gates_forward_pass(t, i, U, x, y)
        else:
            y.copy_(x)
            sg.gates_forward_pass(t, i, U, y, y)
        if ps.map:
            sg.gates_backward_pass(t, i, U, y, None, bx, None, None, {}, two=True)
            sg.gates_backward_pass(t, i, U, lam, None, bl, None, None, {}, two=True)
            if ps.gates:
                sg.gates_backward_pass(t, i, U, bx, bl, bx, bl, partials, {}, nomap=True)
        else:
            bx.copy_(y)
            bl.copy_(lam)
            sg.gates_backward_pass(t, i, U, bx, bl, bx, bl, partials, {})
        torch.cuda.synchronize()
        last = (1 << (nl - ps.k)) - 1
        blocks = torch.cat([torch.tensor([0, last]),
                            torch.randint(0, last + 1, (SHARD_BLOCKS - 2,), generator=gen)])
        blocks = blocks.to(device)
        dst, vals = _shard_pass_plain(ps, U64, x, blocks)
        got = _planes_at(y, dst)
        fwd_err = max(fwd_err, _rel64(got, vals))
        abs_fwd = max(abs_fwd, float((got - vals).abs().max()))
        src, tx, tl, records = _shard_adjoint_plain(ps, Uh, y, lam, blocks)
        errs = [_rel64(_planes_at(bx, src), tx), _rel64(_planes_at(bl, src), tl),
                _rel64(_planes_at(bx, src), _planes_at(x, src))]
        abs_bwd = max(abs_bwd, float((_planes_at(bx, src) - tx).abs().max()))
        for (_, q), off in zip(ps.gates, ps.slots):
            rec = partials[off + blocks].double().reshape(-1, 2, 2, 2)
            errs.append(_rel64(rec, torch.view_as_real(records[q])))
        bwd_err = max(bwd_err, *errs)
        what = f"shard pass {i} of {len(t.passes)} ({nl} local bits, k={ps.k}, map {ps.map})"
        require(fwd_err <= TOL["gates_pass_fwd"], f"{what}: forward rel err {fwd_err:.3e}")
        require(bwd_err <= TOL["gates_pass_bwd"], f"{what}: adjoint rel err {bwd_err:.3e}")
        x, y = y, x
    require(not bool(partials.isnan().any()), "shard passes: a dU record was never written")
    slot_rows = slots[0].cpu().tolist()
    du = sg.gates_reduce(partials, slots[0], nl)
    want = torch.stack([partials[o:o + c].double().sum(0) for o, c in slot_rows])
    red_err = _rel64(torch.view_as_real(du).reshape(nl, 8), want)
    abs_red = float((torch.view_as_real(du).reshape(nl, 8).double() - want).abs().max())
    require(red_err <= TOL["gates_reduce"], f"gates_reduce: rel err {red_err:.3e}")
    print(f"shard passes n={N_SHARD} on {SHARD_RANKS} ranks ({nl} local bits, rank "
          f"{SHARD_RANKS - 1}, {len(t.passes)} passes): fwd rel {fwd_err:.2e}, adjoint and dU "
          f"records rel {bwd_err:.2e} on {SHARD_BLOCKS} tiles a pass; gates_reduce rel "
          f"{red_err:.2e} over {nl} gates", flush=True)
    del bx, bl
    torch.cuda.empty_cache()
    if not timing:
        del x, y, lam, partials
        torch.cuda.empty_cache()
        return []

    def fwd_layer():
        a, b = x, y
        for i, ps in enumerate(t.passes):
            if ps.map:
                sg.gates_forward_pass(t, i, U, a, b)
                a, b = b, a
            else:
                sg.gates_forward_pass(t, i, U, a, a)

    def bwd_layer():
        a, l, s = x, lam, y
        for i in reversed(range(len(t.passes))):
            ps = t.passes[i]
            if ps.map:
                sg.gates_backward_pass(t, i, U, a, None, s, None, None, {}, two=True)
                a, s = s, a
                sg.gates_backward_pass(t, i, U, l, None, s, None, None, {}, two=True)
                l, s = s, l
                if ps.gates:
                    sg.gates_backward_pass(t, i, U, a, l, a, l, partials, {}, nomap=True)
            else:
                sg.gates_backward_pass(t, i, U, a, l, a, l, partials, {})

    gates = sum(len(ps.gates) for ps in t.passes)
    fwd_bytes = 16 * size * len(t.passes)
    bwd_bytes = 32 * size * sum(1 + (ps.map and bool(ps.gates)) for ps in t.passes)
    fwd_bound, bwd_bound = bound(14 * gates * size, fwd_bytes), bound(44 * gates * size, bwd_bytes)
    red_bound = bound(8 * partials.shape[0], 32 * partials.shape[0])
    t_wide = functools.partial(time_ms, reps=WIDE_REPS, rounds=WIDE_ROUNDS)
    out = [
        dict(name="gates_pass_fwd", max_abs_err=abs_fwd, rel_err=fwd_err, ms=t_wide(fwd_layer),
             plain_ms=None, bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=None),
        dict(name="gates_pass_bwd", max_abs_err=abs_bwd, rel_err=bwd_err, ms=t_wide(bwd_layer),
             plain_ms=None, bound_ms=bwd_bound[0], bound_by=bwd_bound[1], library_ms=None),
        dict(name="gates_reduce", max_abs_err=abs_red, rel_err=red_err,
             ms=time_ms(lambda: sg.gates_reduce(partials, slots[0], nl)), plain_ms=None,
             bound_ms=red_bound[0], bound_by=red_bound[1], library_ms=None),
    ]
    print("shard passes a layer: " + ", ".join(
        f"{r['name']} {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} ms, {r['bound_by']})"
        for r in out), flush=True)
    del x, y, lam, partials
    torch.cuda.empty_cache()
    return out


def check_pair_kernels(device, timing=True):
    """The global-pair combines on a piece of SHARD_PIECE amplitudes at the
    shard's last offset (the offset's high bits enter the table entry),
    against their float64 plain versions on the card: this rank's bit b = 0
    and 1, for a rotation (one entry), the CNOT table (I, X) whose control
    is local bit 0 as at the ring's CNOT(31, 0), the same with a high bit
    in the mask, and four entries from two masks. The backward's dU row is
    its records summed by ``gates_reduce``. Timed on the rotation, b = 1,
    against the plain versions in FP32."""
    import torch
    from tensornetworks_tpu_torch.ops.kernels import shard_gates as sg

    P, offset = SHARD_PIECE, (1 << (N_SHARD - 2)) - SHARD_PIECE
    gen = torch.Generator().manual_seed(1)

    def unitaries(e):
        z = torch.randn((e, 2, 2), generator=gen, dtype=torch.complex128)
        return torch.linalg.qr(z)[0]

    eye = torch.eye(2, dtype=torch.complex128)
    cases = [(unitaries(1), 0, 0), (torch.stack([eye, eye.flip(0)]), 1, 0),
             (torch.stack([eye, eye.flip(0)]), (1 << 29) | 1, 0), (unitaries(4), 1, 1 << 27)]
    dgen = torch.Generator(device=device).manual_seed(1)
    x, lam, tx, tl = (torch.randn((2, P), generator=dgen, device=device) for _ in range(4))
    partials = torch.empty((sg.pair_records(P), 8), device=device)
    slots = torch.tensor([[0, sg.pair_records(P)]], dtype=torch.int32, device=device)
    fwd_err = bwd_err = abs_fwd = abs_bwd = 0.0
    for coef, m1, m2 in cases:
        coef_d = coef.to(device)
        for b in (0, 1):
            mine = x.clone()
            sg.pair_forward(mine, (tx[0], tx[1]), coef_d, offset, m1, m2, b)
            want = x.double()
            sg.pair_forward_plain(want, tx.double(), coef_d, offset, m1, m2, b)
            fwd_err = max(fwd_err, rel_err(mine.double(), want))
            abs_fwd = max(abs_fwd, float((mine.double() - want).abs().max()))
            gx, gl = x.clone(), lam.clone()
            sg.pair_backward(gx, gl, (tx[0], tx[1]), (tl[0], tl[1]), coef_d, offset, m1, m2, b,
                             partials, True)
            du = sg.gates_reduce(partials, slots, 1)[0]
            wx, wl = x.double(), lam.double()
            dU = sg.pair_backward_plain(wx, wl, tx.double(), tl.double(), coef_d, offset, m1, m2,
                                        b, True)
            errs = [rel_err(gx.double(), wx), rel_err(gl.double(), wl),
                    _rel64(du[b].to(torch.complex128), dU[b])]
            abs_bwd = max(abs_bwd, float((gx.double() - wx).abs().max()),
                          float((gl.double() - wl).abs().max()))
            bwd_err = max(bwd_err, *errs)
            what = f"pair combine (b={b}, m1={m1:#x}, m2={m2:#x}, {coef.shape[0]} entries)"
            require(fwd_err <= TOL["pair_fwd"], f"{what}: forward rel err {fwd_err:.3e}")
            require(bwd_err <= TOL["pair_bwd"], f"{what}: adjoint rel err {bwd_err:.3e}")
    print(f"pair combines on {P} amplitudes at offset {offset:#x}: fwd rel {fwd_err:.2e}, "
          f"adjoint and dU row rel {bwd_err:.2e} over {2 * len(cases)} cases", flush=True)
    if not timing:
        return []
    coef_d = cases[0][0].to(device)
    coef32 = coef_d.to(torch.complex64)
    fwd_bound, bwd_bound = bound(16 * P, 24 * P), bound(64 * P, 48 * P)
    t_plain = functools.partial(time_ms, reps=WIDE_REPS, rounds=WIDE_ROUNDS)
    out = [
        dict(name="pair_fwd", max_abs_err=abs_fwd, rel_err=fwd_err,
             ms=time_ms(lambda: sg.pair_forward(x, (tx[0], tx[1]), coef_d, offset, 0, 0, 1)),
             plain_ms=t_plain(lambda: sg.pair_forward_plain(x, tx, coef32, offset, 0, 0, 1)),
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=None),
        dict(name="pair_bwd", max_abs_err=abs_bwd, rel_err=bwd_err,
             ms=time_ms(lambda: sg.pair_backward(x, lam, (tx[0], tx[1]), (tl[0], tl[1]), coef_d,
                                                 offset, 0, 0, 1, partials, True)),
             plain_ms=t_plain(lambda: sg.pair_backward_plain(x, lam, tx, tl, coef32, offset, 0,
                                                             0, 1, True)),
             bound_ms=bwd_bound[0], bound_by=bwd_bound[1], library_ms=None),
    ]
    print("pair combines: " + ", ".join(
        f"{r['name']} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} "
        f"ms, {r['bound_by']})" for r in out), flush=True)
    del x, lam, tx, tl, partials
    torch.cuda.empty_cache()
    return out


def check_circuit(n, device, timing, grid=False, ansatz=ANSATZ, layers=LAYERS, edges=None,
                  oracle=True):
    """A circuit kernel pair (circuit2d, or circuit2d_grid with ``grid``)
    against its plain version, and the θ-gradient through the model against
    plain autograd; for bn_structured with ``oracle`` also probabilities and
    θ-gradient against the float64 oracle. With ``grid`` the dense kernels
    run in FP32 beside the gate path (``check_gates``), which the model's
    θ-gradient goes through."""
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
    gates = check_gates(plan, theta, g, timing) if grid else []
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
    ] + gates


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
    circuit2d_grid (bn_structured, L=8) at 24, timed; the gate path at
    sampled28's shape (``check_wide_gates``). Returns the timed records."""
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
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    records += timed(f"circuit_gates n={N_SAMPLED28}", check_wide_gates, N_SAMPLED28, device)
    for r in records:
        r.setdefault("n", n)
        r["share"] = r["bound_ms"] / r["ms"]
    return records


# Mangled-name parts of the kernels whose registers are printed on a line of
# their own: the persistent n <= 17 forward at each precision P of its
# template parameter (0 FP32, 1 high, 2 default) and backward (FP32), the
# n <= 17 cluster butterfly, and the large GEMM loop's (FP32) scatter
# instantiation (<AK, BKC, CA, CB, SCATTER> = <1, 0, 0, 0, 1>); the bf16
# backward of kernel 2 (csrc/circuit_bf16.cuh) at each bf16 precision P.
NEW_KERNELS = {"circuit2d_fwd_kernelILi0E": "circuit2d_fwd_kernel",
               "20circuit2d_bwd_kernelE": "circuit2d_bwd_kernel",
               "cluster_butterfly_kernel": "cluster_butterfly_kernel",
               "cgemm_large_kernelILb1ELb0ELb0ELb0ELb1EE": "cgemm_large_kernel<scatter>",
               "circuit2d_fwd_kernelILi1E": "circuit2d_fwd_kernel<high>",
               "circuit2d_fwd_kernelILi2E": "circuit2d_fwd_kernel<default>",
               "circuit2d_bwd_bf16_kernelILi1E": "circuit2d_bwd_bf16_kernel<high>",
               "circuit2d_bwd_bf16_kernelILi2E": "circuit2d_bwd_bf16_kernel<default>"}
# The Hopper loop of the bf16 products of kernels 5-6 (csrc/wgmma_bf16.cuh,
# cgemm_wgmma_kernel<AT, BT, CA, CB, SCATTER, P, BN>): each product pattern
# at both bf16 precisions and both tile widths.
WGMMA_PATTERNS = {"col": (0, 1, 0, 1, 0), "dmc": (1, 1, 0, 1, 0), "row": (1, 1, 1, 0, 0),
                  "dmr": (0, 0, 0, 1, 0), "left": (0, 1, 0, 0, 0), "scatter": (0, 0, 0, 0, 1)}
NEW_KERNELS.update({
    "cgemm_wgmma_kernelI" + "".join(f"Lb{b}E" for b in bits) + f"Li{code}ELi{bn}EE":
        f"cgemm_wgmma_kernel<{pattern}, {prec}, {bn}>"
    for pattern, bits in WGMMA_PATTERNS.items() for code, prec in ((1, "high"), (2, "default"))
    for bn in (64, 128)})


def check_spills(logs, kernels=("cgemm_large_kernel", "butterfly_pass_kernel",
                                "cluster_butterfly_kernel", "circuit2d_fwd_kernel",
                                "circuit2d_bwd_kernel", "circuit2d_bwd_bf16_kernel",
                                "cgemm_wgmma_kernel")):
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
    from tensornetworks_tpu_torch.models import QuantumBornMachine
    from tensornetworks_tpu_torch.ops import kernels
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
    ref_loss = scale20_reference_loss(theta0)
    loss_err = abs(loss[0] - ref_loss) / abs(ref_loss)
    require(loss_err < 1e-4, f"scale20 epoch-0 loss {loss[0]} vs float64 {ref_loss}")
    eps = hist.get("epochs_per_sec_steady", hist["epochs_per_sec"])
    print(f"scale20 path: {SCALE_EPOCHS} epochs, loss {loss[0]:.5f} -> {loss[-1]:.5f} "
          f"(epoch-0 rel err vs float64 {loss_err:.1e}), best TVD {model.best_tvd_:.5f}, "
          f"{eps:.2f} epochs/s steady, launches {launches}", flush=True)
    return launches, eps, hist


def scale20_reference_loss(theta0):
    """Epoch 0's loss of the scale20 configuration at θ0 in float64: the
    grid kernels' plain circuit and the 3n+1-column Stein oracle, at the
    run's length scale ("auto": 2/n)."""
    import torch
    from tensornetworks_tpu_torch.core import all_bitstrings
    from tensornetworks_tpu_torch.ops.hamming import resolve_length_scale
    from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg
    from tensornetworks_tpu_torch.ops.stein import score_table, stein_matvec

    n = N_GRID
    bn, latent, obs = path_inputs(n)
    plan = kg.GridPlan(n, LAYERS, ANSATZ)
    f64 = dict(dtype=torch.float64, device=theta0.device)
    S = torch.as_tensor(score_table(bn.conditional_joint_table(latent, obs)), **f64)
    B = torch.as_tensor(all_bitstrings(n), **f64)
    with torch.no_grad():
        q = kg.circuit2d_grid_forward_plain(*kg.grid_operators(theta0.double(), plan),
                                            plan)[0].reshape(-1)
        y = stein_matvec(q, S, B, n, resolve_length_scale("auto", n))
        return math.sqrt(max(float(q @ y), 1e-12))


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
    REFERENCE_RUNS["exact24"] = hist
    return launches, steady

@functools.lru_cache(maxsize=None)
def sampled_problem(n):
    """(network, latent names, observation) of sampled24 (a random chain
    network of 26 variables, seed 11, V24=1 and V25=0) or sampled28 (29
    variables, seed 11, V28=1)."""
    from tensornetworks_tpu_torch.core import get_random_chain_network

    latent = [f"V{i}" for i in range(n)]
    if n == N_SAMPLED24:
        return get_random_chain_network(n + 2, seed=11), latent, {f"V{n}": 1, f"V{n + 1}": 0}
    return get_random_chain_network(n + 1, seed=11), latent, {f"V{n}": 1}


def initial_q(n, layers, device, ansatz=ANSATZ, edges=None):
    """A Born machine's q at its initial θ (seed 0, as the engines draw it)."""
    import torch
    from tensornetworks_tpu_torch.models import QuantumBornMachine

    qbm = QuantumBornMachine(n, layers, ansatz, device=device, edges=edges)
    with torch.no_grad():
        return qbm.probs(qbm.init(torch.Generator().manual_seed(0)))


def grid_view(q, n):
    """The (R, C) = (2^⌈n/2⌉, 2^⌊n/2⌋) view of a flat distribution."""
    return q.reshape(1 << ((n + 1) // 2), -1)


def model_marginals(q, n):
    """P(z_i = 1) of every latent bit, in q's dtype, from two axis reductions
    of the (R, C) view (scripts/quality28_sampled.py's measure: no 2^n
    buffer beyond q)."""
    import torch

    P = grid_view(q, n)
    rb, cb = (n + 1) // 2, n // 2
    r, c = P.sum(dim=1).reshape((2,) * rb), P.sum(dim=0).reshape((2,) * cb)
    return torch.stack([r.sum(dim=tuple(j for j in range(rb) if j != i))[1] for i in range(rb)]
                       + [c.sum(dim=tuple(j for j in range(cb) if j != i))[1]
                          for i in range(cb)])


def marginal_report(path, n, qbm, theta_init, theta_end):
    """The per-variable posterior-marginal error of the Born machine at its
    initial and final θ: mean and max |Δp| over the n latent bits against
    likelihood weighting (LW_SAMPLES samples, seed 0) on the path's network.
    The card's FP32 reduction is held against a float64 reduction of the
    same probabilities. A report, not a limit."""
    import numpy as np
    import torch

    bn, latent, obs = sampled_problem(n)
    t0 = time.perf_counter()
    target = bn.likelihood_weighted_marginals(latent, obs, num_samples=LW_SAMPLES, seed=0)
    ess = target.pop("__ess__")
    t_lw = time.perf_counter() - t0
    want = np.array([target[v] for v in latent])
    out, red_err = {"lw_ess": ess}, 0.0
    for label, theta in (("init", theta_init), ("end", theta_end)):
        with torch.no_grad():
            q = qbm.probs(theta)
            m32 = model_marginals(q, n)
            m64 = model_marginals(q.double(), n)
            del q
        red_err = max(red_err, float((m32.double() - m64).abs().max()))
        d = np.abs(m32.double().cpu().numpy() - want)
        out[f"marginal_err_{label}"] = [float(d.mean()), float(d.max())]
    require(red_err <= MARGINAL_REDUCTION_TOL,
            f"{path} FP32 marginals {red_err:.1e} from float64 (limit {MARGINAL_REDUCTION_TOL})")
    out["marginal_reduction_err"] = red_err
    print(f"{path} marginal error against likelihood weighting ({LW_SAMPLES:,} samples, ESS "
          f"{ess:,.0f}, {t_lw:.1f}s on the host): mean/max |dp| "
          f"{out['marginal_err_init'][0]:.4f}/{out['marginal_err_init'][1]:.4f} at init -> "
          f"{out['marginal_err_end'][0]:.4f}/{out['marginal_err_end'][1]:.4f} at the end; "
          f"FP32 reduction {red_err:.1e} from float64", flush=True)
    return out


def check_draws(label, P, device, seed):
    """Shots on the card against the float64 draw on the CPU from the same
    uniforms (flat P: sample_indices; (R, C) P: sample_indices_2d): every
    index that differs must be a rounding tie. Returns the count."""
    import torch
    from tensornetworks_tpu_torch.sim.sampling import (draw_uniforms, sample_indices,
                                                       sample_indices_2d, step_distances)

    gen = torch.Generator(device=device).manual_seed(seed)
    u = [draw_uniforms(gen, SHOTS) for _ in range(P.ndim)]
    u_cpu = [x.double().cpu() for x in u]
    if P.ndim == 1:
        got, want = sample_indices(P, *u), sample_indices(P.double().cpu(), *u_cpu)
    else:
        got, want = sample_indices_2d(P, *u)[0], sample_indices_2d(P.double().cpu(), *u_cpu)[0]
    dist = step_distances(P, got.cpu(), want, *u_cpu)
    require(bool((dist <= TIE_DISTANCE).all()),
            f"{label}: shots differ from float64 off a rounding tie: distances {dist}")
    print(f"{label}: {SHOTS} shots, {dist.size} differ from the float64 draw, each within "
          f"{TIE_DISTANCE} of its CDF step (max {dist.max() if dist.size else 0.0:.1e})",
          flush=True)
    return int(dist.size)


def check_blocked_adjoint(n, device):
    """The blocked executor with its adjoint backward against the
    circuit2d_grid kernels (HE L=4): probabilities and the θ-gradient of
    q·g for the same θ and g. Returns (forward rel err, gradient rel err)."""
    import torch
    from tensornetworks_tpu_torch.models import QuantumBornMachine

    gen = torch.Generator().manual_seed(n)
    theta = (0.1 * torch.randn(3 * n * LAYERS, generator=gen)).to(device)
    g = torch.randn(2**n, generator=gen).to(device)
    out = []
    for backend, kw in (("circuit2d_grid", {}), ("blocked", {"grad_method": "adjoint"})):
        qbm = QuantumBornMachine(n, LAYERS, ANSATZ, backend=backend, device=device, **kw)
        p = theta.clone().requires_grad_(True)
        probs = qbm.probs(p)
        (probs @ g).backward()
        out.append((probs.detach(), p.grad))
    torch.cuda.synchronize()
    (q_k, g_k), (q_b, g_b) = out
    fwd, bwd = rel_err(q_b, q_k), rel_err(g_b, g_k)
    what = f"blocked adjoint n={n} (HE L={LAYERS})"
    require(bool(torch.isfinite(q_b).all() and torch.isfinite(g_b).all()), f"{what}: not finite")
    require(fwd <= BLOCKED_TOL["fwd"], f"{what}: probs vs circuit2d_grid rel err {fwd:.3e}")
    require(bwd <= BLOCKED_TOL["bwd"], f"{what}: θ-gradient vs circuit2d_grid rel err {bwd:.3e}")
    print(f"{what} against circuit2d_grid: probs rel {fwd:.2e}, θ-grad rel {bwd:.2e}",
          flush=True)
    return fwd, bwd


def check_sampler_replay(device):
    """The sampler's two summing steps give the same bits on every run: the
    CDF scan of a flat normalised q at n=24 (``sampling._cumsum``, the
    blocked scan on the card) and the backward of the two-stage log-q gather
    (``gather_2d``, SHOTS shots on 16 states), each three times, and each
    against float64. Returns (scan abs err, gather-gradient rel err)."""
    import numpy as np
    import torch
    from tensornetworks_tpu_torch.sim.sampling import _cumsum, gather_2d

    n = N_SAMPLED24
    q = initial_q(n, LAYERS, device)
    p = q / q.sum()
    cdfs = [_cumsum(p) for _ in range(3)]
    cdf_err = float(np.abs(cdfs[0].double().cpu().numpy()
                           - np.cumsum(p.double().cpu().numpy())).max())
    require(all(torch.equal(c, cdfs[0]) for c in cdfs), f"CDF scan n={n}: runs differ")
    require(cdf_err <= CDF_TOL, f"CDF scan n={n}: abs err {cdf_err:.3e} against float64")
    P = grid_view(q, n).clone().requires_grad_(True)
    gen = torch.Generator(device=device).manual_seed(5)
    r = torch.randint(0, 4, (SHOTS,), generator=gen, device=device)
    c = torch.randint(0, 4, (SHOTS,), generator=gen, device=device)
    g = torch.randn(SHOTS, generator=gen, device=device)
    grads = [torch.autograd.grad(gather_2d(P, r, c), P, g)[0] for _ in range(3)]
    want = torch.zeros(P.numel(), dtype=torch.float64, device=device).index_add_(
        0, r * P.shape[1] + c, g.double()).reshape(P.shape)
    gather_err = rel_err(grads[0].double(), want)
    require(all(torch.equal(x, grads[0]) for x in grads), "gather_2d backward: runs differ")
    require(gather_err <= GATHER_TOL, f"gather_2d backward: rel err {gather_err:.3e}")
    print(f"sampler replay n={n}: CDF scan three times bit-equal, abs {cdf_err:.1e} against "
          f"float64 (limit {CDF_TOL}); gather_2d backward ({SHOTS} shots on 16 states) three "
          f"times bit-equal, rel {gather_err:.1e} (limit {GATHER_TOL})", flush=True)
    return cdf_err, gather_err


def check_sampling_ops(device):
    """Step 12's op checks: the samplers at n = 16, 20 and 28, their replay
    (``check_sampler_replay``), the sample Gram at n=24, the blocked adjoint
    at n = 20 and 24."""
    import torch
    from tensornetworks_tpu_torch.core.bits import torch_index_to_bits
    from tensornetworks_tpu_torch.core.factors import make_latent_log_joint_fn
    from tensornetworks_tpu_torch.engines import SampledKSDVariationalInference
    from tensornetworks_tpu_torch.ops.stein_sampled import score_at_samples, stein_gram_samples
    from tensornetworks_tpu_torch.sim.sampling import inverse_cdf_sampler

    ties = {}
    ties[N] = check_draws(f"sample_indices n={N} (bn16's initial q)",
                          initial_q(N, BN_LAYERS, device, BN, path_edges(N)), device, 1)
    q20 = initial_q(N_SAMPLING, SAMPLING_LAYERS, device)
    ties[N_SAMPLING] = check_draws(f"sample_indices_2d n={N_SAMPLING}",
                                   grid_view(q20, N_SAMPLING), device, 2)
    bn, latent, obs = sampled_problem(N_SAMPLED28)
    eng = SampledKSDVariationalInference(bn, latent, list(obs), num_samples=SHOTS, seed=0,
                                         device=device)
    with torch.no_grad():
        q28 = eng.born_machine.probs(eng.params)
    ties[N_SAMPLED28] = check_draws(f"sample_indices_2d n={N_SAMPLED28}",
                                    grid_view(q28, N_SAMPLED28), device, 3)
    del q28, eng
    cdf_err, gather_err = check_sampler_replay(device)
    n = N_SAMPLED24
    bn, latent, obs = sampled_problem(n)
    P = grid_view(initial_q(n, LAYERS, device), n)
    idx, _, _ = inverse_cdf_sampler(P, SHOTS, torch.Generator(device=device).manual_seed(4))
    Z = torch_index_to_bits(idx, n)
    S = score_at_samples(make_latent_log_joint_fn(bn, latent, obs, device=device), Z)
    gram = stein_gram_samples(S, Z, n, 1.0)
    gram64 = stein_gram_samples(S.double(), Z.double(), n, 1.0)
    torch.cuda.synchronize()
    err = rel_err(gram.double(), gram64)
    require(bool(torch.isfinite(gram).all()), "stein_gram_samples n=24 not finite")
    require(err <= GRAM_TOL, f"stein_gram_samples n={n}: rel err {err:.3e} against float64")
    print(f"stein_gram_samples n={n}, M={SHOTS}: rel {err:.2e} against float64 "
          f"(limit {GRAM_TOL})", flush=True)
    blocked = {m: check_blocked_adjoint(m, device) for m in (N_GRID, N_EXACT24)}
    return {"ties": ties, "gram_rel_err": err, "cdf_abs_err": cdf_err,
            "gather_rel_err": gather_err,
            "blocked_rel_err": {m: {"fwd": f, "bwd": b} for m, (f, b) in blocked.items()}}


def check_ustat_history(path, hist, chunk):
    """Every U-statistic finite, no skipped update, and the last chunk's
    mean below the first's. Returns (first chunk's mean, last chunk's)."""
    loss = hist["loss_ksd"]
    require(all(math.isfinite(x) for x in loss), f"{path} U-statistic not finite")
    require(hist["num_skipped_updates"] == 0, f"{path} skipped updates")
    first, last = statistics.mean(loss[:chunk]), statistics.mean(loss[-chunk:])
    require(last < first, f"{path} last chunk's mean U-statistic {last} not below the "
                          f"first's {first}")
    return first, last


def sampled_row(path, hist, launches, peak, best_tvd=None):
    eps = hist.get("epochs_per_sec_steady", hist["epochs_per_sec"])
    return {"path": path, "epochs_per_sec": eps, "launches": launches,
            "ustat_first": hist["loss_ksd"][0], "ustat_last": hist["loss_ksd"][-1],
            "best_tvd": best_tvd, "peak_gib": peak}


def run_sampled16_path(device):
    """scripts/quality_sampled.py's configuration, one phase of 2000 epochs:
    bn_structured L=8 at 16 qubits through the circuit kernels."""
    import torch
    from tensornetworks_tpu_torch.engines import SampledKSDVariationalInference
    from tensornetworks_tpu_torch.ops import kernels

    bn, latent, obs = path_inputs(N)
    post = bn.posterior_vector(latent, obs)
    eng = SampledKSDVariationalInference(bn, latent, list(obs), qbm_ansatz_layers=BN_LAYERS,
                                         qbm_ansatz_type=BN, num_samples=SHOTS, seed=0,
                                         base_kernel_length_scale="auto", grad_baseline="loo",
                                         device=device)
    require(eng.born_machine.backend == "circuit2d", "sampled16 is not on circuit2d")
    require(eng.sampling == "flat", f"sampled16 samples {eng.sampling}")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    hist = eng.train(obs, num_epochs=SAMPLED16_EPOCHS, lr_born_machine=BN_LR, verbose=False,
                     true_posterior_for_tvd=post, chunk_epochs=SAMPLED16_CHUNK,
                     reuse_loss_forward_for_eval=True, seed=0)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_launches("sampled16", launches)
    loss = hist["loss_ksd"]
    require(all(math.isfinite(x) for x in loss), "sampled16 U-statistic not finite")
    require(eng.best_tvd_ <= SAMPLED16_TVD_MAX,
            f"sampled16 best TVD {eng.best_tvd_} > {SAMPLED16_TVD_MAX}")
    row = sampled_row("sampled16", hist, launches, peak, eng.best_tvd_)
    REFERENCE_RUNS["sampled16"] = (hist, eng.best_tvd_, eng.best_epoch_)
    print(f"sampled16 path: {SAMPLED16_EPOCHS} epochs, U-statistic {loss[0]:.4f} -> "
          f"{loss[-1]:.4f}, best TVD {eng.best_tvd_:.5f} (limit {SAMPLED16_TVD_MAX:.5f}) at "
          f"epoch {eng.best_epoch_}, {hist['num_skipped_updates']} skipped, "
          f"{row['epochs_per_sec']:.1f} epochs/s steady, peak device memory {peak:.2f} GiB, "
          f"launches {launches}", flush=True)
    return launches, row


def run_sampled16_replay(device, first):
    """sampled16 again with the same seed: its histories, best TVD and best
    epoch equal the first run's (``first``: its history, best TVD, best
    epoch) bit for bit. Returns the launches."""
    import torch
    from tensornetworks_tpu_torch.engines import SampledKSDVariationalInference
    from tensornetworks_tpu_torch.ops import kernels

    bn, latent, obs = path_inputs(N)
    post = bn.posterior_vector(latent, obs)
    eng = SampledKSDVariationalInference(bn, latent, list(obs), qbm_ansatz_layers=BN_LAYERS,
                                         qbm_ansatz_type=BN, num_samples=SHOTS, seed=0,
                                         base_kernel_length_scale="auto", grad_baseline="loo",
                                         device=device)
    kernels.reset_launches()
    hist = eng.train(obs, num_epochs=SAMPLED16_EPOCHS, lr_born_machine=BN_LR, verbose=False,
                     true_posterior_for_tvd=post, chunk_epochs=SAMPLED16_CHUNK,
                     reuse_loss_forward_for_eval=True, seed=0)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_launches("sampled16", launches)
    ref, ref_best, ref_epoch = first
    for key in ("loss_ksd", "tvd", "grad_norm"):
        diff = [e for e, (a, b) in enumerate(zip(hist[key], ref[key]))
                if not (a == b or (math.isnan(a) and math.isnan(b)))]
        require(not diff and len(hist[key]) == len(ref[key]),
                f"sampled16 replay: {key} differs from the first run from epoch "
                f"{diff[0] if diff else len(ref[key])}")
    require(eng.best_tvd_ == ref_best and eng.best_epoch_ == ref_epoch,
            f"sampled16 replay: best TVD {eng.best_tvd_} at {eng.best_epoch_}, first run "
            f"{ref_best} at {ref_epoch}")
    print(f"sampled16 replay: {SAMPLED16_EPOCHS} epochs with the same seed, loss, TVD and "
          f"gradient-norm histories equal bit for bit, best TVD {eng.best_tvd_:.5f} at epoch "
          f"{eng.best_epoch_} as the first run", flush=True)
    return launches


def run_sampled24_path(device):
    """examples/sampled_ksd_large_n.py at full width, 20 epochs in chunks of
    10; epoch 0's U-statistic against float64 on the recorded shots."""
    import numpy as np
    import torch
    from tensornetworks_tpu_torch.core.bits import torch_index_to_bits
    from tensornetworks_tpu_torch.core.factors import make_latent_log_joint_fn
    from tensornetworks_tpu_torch.engines import SampledKSDVariationalInference
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.ops.stein_sampled import (ksd_ustat, score_at_samples,
                                                            stein_gram_samples)
    from tensornetworks_tpu_torch.sim.sampling import inverse_cdf_sampler

    n = N_SAMPLED24
    bn, latent, obs = sampled_problem(n)
    t0 = time.perf_counter()
    post = bn.posterior_vector(latent, obs).astype(np.float32)
    t_post = time.perf_counter() - t0
    eng = SampledKSDVariationalInference(bn, latent, list(obs), qbm_ansatz_layers=LAYERS,
                                         num_samples=SHOTS, seed=0, device=device)
    require(eng.born_machine.backend == "circuit2d_grid", "sampled24 is not on circuit2d_grid")
    require(eng.sampling == "two_stage", f"sampled24 samples {eng.sampling}")
    shots = []

    def recording(P, num_samples, generator):
        out = inverse_cdf_sampler(P, num_samples, generator)
        if not shots:
            shots.append(out[0].clone())
        return out

    theta0 = eng.params.clone()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    hist = eng.train(obs, num_epochs=SAMPLED24_EPOCHS, lr_born_machine=0.05, verbose=False,
                     true_posterior_for_tvd=post, chunk_epochs=SAMPLED24_CHUNK,
                     sampler=recording)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_launches("sampled24", launches)
    first, last = check_ustat_history("sampled24", hist, SAMPLED24_CHUNK)
    # Epoch 0's U-statistic in float64 on its recorded shots.
    Z = torch_index_to_bits(shots[0], n, dtype=torch.float64)
    S = score_at_samples(make_latent_log_joint_fn(bn, latent, obs, torch.float64, device), Z)
    ref = float(ksd_ustat(stein_gram_samples(S, Z, n, eng.length_scale)))
    u0 = hist["loss_ksd"][0]
    err = abs(u0 - ref) / abs(ref)
    require(err < 1e-4, f"sampled24 epoch-0 U-statistic {u0} vs float64 {ref}")
    row = sampled_row("sampled24", hist, launches, peak, eng.best_tvd_)
    require(math.isfinite(eng.best_tvd_), "sampled24 TVD not finite")
    print(f"sampled24 path: {SAMPLED24_EPOCHS} epochs, U-statistic {u0:.3f} -> "
          f"{hist['loss_ksd'][-1]:.3f}, chunk means {first:.3f} -> {last:.3f} (epoch-0 rel err "
          f"vs float64 {err:.1e}), TVD {hist['tvd'][0]:.5f} -> {hist['tvd'][-1]:.5f}, best "
          f"{eng.best_tvd_:.5f}, {hist['epochs_per_sec']:.3f} epochs/s, "
          f"{row['epochs_per_sec']:.3f} epochs/s steady, posterior {t_post:.1f}s on the host, "
          f"peak device memory {peak:.2f} GiB, launches {launches}", flush=True)
    row |= marginal_report("sampled24", n, eng.born_machine, theta0, eng.params)
    return launches, row


def run_sampled28_path(device):
    """scripts/probe_sampled_28.py, 6 epochs in chunks of 3: kernels 5-6 on
    the gate path (an FP32 machine under ``highest``)."""
    import torch
    from tensornetworks_tpu_torch.engines import SampledKSDVariationalInference
    from tensornetworks_tpu_torch.ops import kernels

    n = N_SAMPLED28
    bn, latent, obs = sampled_problem(n)
    eng = SampledKSDVariationalInference(bn, latent, list(obs), qbm_ansatz_layers=LAYERS,
                                         num_samples=SHOTS, seed=0, base_kernel_length_scale=1.0,
                                         device=device)
    bm = eng.born_machine
    require((bm.backend, bm.grad_method) == ("circuit2d_grid", "autodiff"),
            f"sampled28 runs {bm.backend}/{bm.grad_method}, not the gate path")
    theta0 = eng.params.clone()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    hist = eng.train(obs, num_epochs=SAMPLED28_EPOCHS, lr_born_machine=0.05, verbose=False,
                     chunk_epochs=SAMPLED28_CHUNK)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_launches("sampled28", launches)
    first, last = check_ustat_history("sampled28", hist, SAMPLED28_CHUNK)
    row = sampled_row("sampled28", hist, launches, peak)
    print(f"sampled28 path: {SAMPLED28_EPOCHS} epochs, U-statistic {hist['loss_ksd'][0]:.3f} "
          f"-> {hist['loss_ksd'][-1]:.3f}, chunk means {first:.3f} -> {last:.3f}, "
          f"{hist['epochs_per_sec']:.3f} epochs/s, {row['epochs_per_sec']:.3f} epochs/s "
          f"steady, peak device memory {peak:.2f} GiB, launches {launches}", flush=True)
    row |= marginal_report("sampled28", n, bm, theta0, eng.params)
    REFERENCE_RUNS["sampled28"] = hist
    return launches, row


def run_sampling20(device):
    """run_sampling_throughput at its defaults: the n=20 HE L=2 forward and
    65536 inverse-CDF shots per draw."""
    import torch
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.runners import run_sampling_throughput

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out = run_sampling_throughput(N_SAMPLING, layers=SAMPLING_LAYERS, num_samples=SAMPLING_SHOTS,
                                  verbose=False, device=device)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_launches("sampling20", launches)
    require(out["samples_per_sec"] > 0, "sampling20 drew nothing")
    print(f"sampling20 path: {out['samples_per_sec']:,.0f} samples/s ({SAMPLING_SHOTS} shots a "
          f"draw, forward included), peak device memory {peak:.2f} GiB, launches {launches}",
          flush=True)
    return launches, {"path": "sampling20", "samples_per_sec": out["samples_per_sec"],
                      "launches": launches, "peak_gib": peak}


def plain_conditioned_probs(qbm, p64, x64):
    """A conditioned Born machine's q in float64 through its kernels' plain
    version: the wall of x folded into float64 operator planes, autograd
    through the plain forward (differentiable in p64, W and s included)."""
    from tensornetworks_tpu_torch.ops.kernels import circuit2d as kc
    from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg

    n, L, ansatz = qbm.num_latent_vars, qbm.ansatz_layers, qbm.ansatz_type
    angles = qbm._embed_angles(x64, p64)
    circ = p64[:qbm.num_circuit_params]
    if qbm.backend == "circuit2d_grid":
        plan = kg.GridPlan(n, L, ansatz, qbm.edges)
        planes = kg.grid_operators(circ, plan, angles, qbm.cond_reupload)
        return kg.circuit2d_grid_forward_plain(*planes, plan)[0].reshape(-1)
    plan = kc.CircuitPlan(n, L, ansatz, qbm.edges)
    Mr, Mc = kc.circuit_operators(circ, plan, angles, qbm.cond_reupload)
    return kc.circuit2d_forward_plain(Mr.real, Mr.imag, Mc.real, Mc.imag, plan)[0].reshape(-1)


def check_conditioned(n, device, grid, ansatz, layers, edges=None, **cond):
    """A conditioned machine's probabilities and θ-gradient through the
    kernels (the wall folded into their operator planes) against the
    float64 plain path on the same θ, W and s moved off their init."""
    import torch
    from tensornetworks_tpu_torch.models import QuantumBornMachine

    name = "circuit2d_grid" if grid else "circuit2d"
    qbm = QuantumBornMachine(n, layers, ansatz, backend=name, device=device, edges=edges,
                             conditioning_dim=COND_D, **cond)
    gen = torch.Generator().manual_seed(n)
    theta = qbm.init(gen) + (0.1 * torch.randn(qbm.num_params, generator=gen)).to(device)
    x = torch.tensor(COND_X, device=device)
    v = torch.randn(2**n, generator=gen).to(device)
    p = theta.clone().requires_grad_(True)
    q = qbm.probs(p, x)
    (g,) = torch.autograd.grad(q @ v, p)
    p64 = theta.double().requires_grad_(True)
    q64 = plain_conditioned_probs(qbm, p64, x.double())
    (g64,) = torch.autograd.grad(q64 @ v.double(), p64)
    torch.cuda.synchronize()
    nc = qbm.num_circuit_params
    fwd = rel_err(q.detach().double(), q64.detach())
    bwd = rel_err(g.double(), g64)
    emb = rel_err(g[nc:].double(), g64[nc:]) if qbm.num_params > nc else None
    what = (f"conditioned {name} n={n} L={layers} {ansatz} "
            + ", ".join(k for k, on in cond.items() if on))
    require(bool(torch.isfinite(q).all() and torch.isfinite(g).all()), f"{what}: not finite")
    require(fwd <= TOL[f"{name}_fwd"], f"{what}: probs vs float64 rel err {fwd:.3e}")
    require(bwd <= TOL[f"{name}_bwd"], f"{what}: gradient vs float64 rel err {bwd:.3e}")
    if emb is not None:
        require(emb <= TOL[f"{name}_bwd"], f"{what}: W, s gradient vs float64 rel err {emb:.3e}")
        require(float(g[nc:].abs().max()) > 0, f"{what}: no gradient reaches W and s")
    print(f"{what}: probs rel {fwd:.2e}, gradient rel {bwd:.2e}"
          + ("" if emb is None else f" (W and s: {emb:.2e})") + " against float64", flush=True)
    return {"check": what, "probs_rel_err": fwd, "grad_rel_err": bwd, "embed_grad_rel_err": emb}


def check_conditioned_kernels(device):
    """n=16: bn_structured L=8, the wall re-uploaded before every layer,
    learned embedding with per-layer scales; n=20: hardware_efficient L=4,
    one fixed wall folded into the first layer's gates (the gate path),
    against the float64 operator planes with the wall before the row
    gather."""
    rows = [check_conditioned(N, device, False, BN, BN_LAYERS, path_edges(N),
                              cond_reupload=True, cond_learned_embedding=True,
                              cond_embed_per_layer=True)]
    rows.append(check_conditioned(N_COND_GRID, device, True, ANSATZ, LAYERS))
    return rows


def amortized16_problem():
    """scripts/quality_amortized16.py's network: 18 variables, seed 0,
    V0..V15 latent, V16 and V17 observed, all 4 observations."""
    from itertools import product

    from tensornetworks_tpu_torch.core import get_random_chain_network

    bn = get_random_chain_network(N + 2, seed=0)
    latent = [f"V{i}" for i in range(N)]
    observed = [f"V{N}", f"V{N + 1}"]
    return bn, latent, observed, [dict(zip(observed, b)) for b in product((0, 1), repeat=2)]


def amortized_reference_loss(eng, theta0, observations, entropy_weight):
    """Epoch 0's amortized loss at θ0 in float64: each observation's q from
    the plain circuit path, its KSD from the 3n+1-column Stein oracle."""
    import torch
    from tensornetworks_tpu_torch.core import all_bitstrings
    from tensornetworks_tpu_torch.ops.stein import score_table, stein_matvec

    n, dev = eng.num_latent_vars, theta0.device
    f64 = dict(dtype=torch.float64, device=dev)
    B = torch.as_tensor(all_bitstrings(n), **f64)
    losses = []
    with torch.no_grad():
        for obs in observations:
            q = plain_conditioned_probs(eng.born_machine, theta0.double(),
                                        torch.tensor(eng._x(obs), **f64))
            S = torch.as_tensor(score_table(eng.bn.conditional_joint_table(
                eng.latent_vars_names, obs)), **f64)
            ksd = math.sqrt(max(float(q @ stein_matvec(q, S, B, n, eng.length_scale)), 1e-12))
            ent = float(-(q * torch.log(q.clamp(min=1e-10))).sum())
            losses.append(ksd - entropy_weight * ent)
            del S
    return sum(losses) / len(losses)


def amortized_row(path, hist, launches, eng, extra=None):
    eps = hist.get("epochs_per_sec_steady", hist["epochs_per_sec"])
    return {"path": path, "epochs_per_sec": eps, "launches": launches,
            "loss_first": float(hist["loss"][0]), "loss_last": float(hist["loss"][-1]),
            "best_mean_tvd": eng.best_mean_tvd_, "best_epoch": eng.best_epoch_} | (extra or {})


def run_amortized16_path(device):
    """One conditioned bn_structured circuit (L=8, re-uploading) trained
    against the 4 observations of the 18-variable network."""
    import torch
    from tensornetworks_tpu_torch.engines import AmortizedKSD
    from tensornetworks_tpu_torch.models import QuantumBornMachine
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.sim import latent_edges

    bn, latent, observed, observations = amortized16_problem()
    qbm = QuantumBornMachine(N, BN_LAYERS, BN, device=device, edges=latent_edges(bn, latent),
                             conditioning_dim=len(observed), cond_reupload=True)
    require(qbm.backend == "circuit2d", f"amortized16 is on {qbm.backend}, not circuit2d")
    eng = AmortizedKSD(bn, latent, observed, born_machine=qbm, seed=0,
                       base_kernel_length_scale="auto")
    theta0 = eng.params.clone()
    kernels.reset_launches()
    hist = eng.train(observations, num_epochs=AMORTIZED16_EPOCHS, lr=AMORTIZED16_LR,
                     gradient_clip_norm=10.0, entropy_weight=0.0, verbose=False, seed=0,
                     chunk_epochs=AMORTIZED16_CHUNK)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_launches("amortized16", launches)
    X, E = len(observations), AMORTIZED16_EPOCHS
    want = {"circuit2d_fwd": X * E + X, "circuit2d_bwd": X * E, "stein2d": X * E,
            "stein_gcorr": X * E}
    for name, count in want.items():
        require(launches[name] == count,
                f"amortized16 launched {name} {launches[name]}x, want {count}")
    loss, tvd = hist["loss"], hist["mean_tvd"]
    require(all(math.isfinite(x) for x in loss), "amortized16 loss not finite")
    require(hist["num_skipped_updates"] == 0, "amortized16 skipped updates")
    require(eng.best_mean_tvd_ < tvd[0],
            f"amortized16 best mean TVD {eng.best_mean_tvd_} not below epoch 0's {tvd[0]}")
    require(eng.best_mean_tvd_ <= AMORTIZED16_TVD_MAX,
            f"amortized16 best mean TVD {eng.best_mean_tvd_} > {AMORTIZED16_TVD_MAX}")
    ref = amortized_reference_loss(eng, theta0, observations, 0.0)
    err = abs(loss[0] - ref) / abs(ref)
    require(err < 1e-4, f"amortized16 epoch-0 loss {loss[0]} vs float64 {ref}")
    per_obs = [float(0.5 * (eng.posterior_for(o).double() - torch.as_tensor(
        bn.posterior_vector(latent, o), device=device)).abs().sum()) for o in observations]
    row = amortized_row("amortized16", hist, launches, eng,
                        {"per_obs_tvd": per_obs, "mean_tvd_epoch0": float(tvd[0])})
    print(f"amortized16 path: {E} epochs over {X} observations, loss {loss[0]:.5f} -> "
          f"{loss[-1]:.5f} (epoch-0 rel err vs float64 {err:.1e}), mean TVD {tvd[0]:.5f} -> "
          f"best {eng.best_mean_tvd_:.5f} (limit {AMORTIZED16_TVD_MAX:.5f}) at epoch "
          f"{eng.best_epoch_}, per observation {', '.join(f'{t:.4f}' for t in per_obs)}, "
          f"{row['epochs_per_sec']:.1f} epochs/s steady, launches {launches}", flush=True)
    return launches, row


def run_amortized20_path(device):
    """``run_amortized_experiment`` at 20 qubits: one conditioned
    hardware_efficient circuit (L=4, one fixed wall) over V20 ∈ {0, 1}."""
    import torch
    from tensornetworks_tpu_torch.models import QuantumBornMachine
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.runners import run_amortized_experiment

    n = N_COND_GRID
    # The run's initial θ: the engine draws it from its seed exactly so.
    theta0 = QuantumBornMachine(n, LAYERS, ANSATZ, device=device, conditioning_dim=1).init(
        torch.Generator().manual_seed(0))
    kernels.reset_launches()
    out = run_amortized_experiment(n, num_epochs=AMORTIZED20_EPOCHS, layers=LAYERS, quantum=True,
                                   ansatz=ANSATZ, seed=0, verbose=False,
                                   chunk_epochs=AMORTIZED20_CHUNK, device=device)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    eng, hist = out["model"], out["history"]
    require(eng.born_machine.backend == "circuit2d_grid",
            f"amortized20 is on {eng.born_machine.backend}, not circuit2d_grid")
    check_launches("amortized20", launches)
    loss = hist["loss"]
    require(all(math.isfinite(x) for x in loss), "amortized20 loss not finite")
    require(hist["num_skipped_updates"] == 0, "amortized20 skipped updates")
    obs_var = f"V{n}"
    ref = amortized_reference_loss(eng, theta0, [{obs_var: 0}, {obs_var: 1}], 1e-3)
    err = abs(loss[0] - ref) / abs(ref)
    require(err < 1e-4, f"amortized20 epoch-0 loss {loss[0]} vs float64 {ref}")
    row = amortized_row("amortized20", hist, launches, eng,
                        {"per_obs_tvd": out["per_obs_tvd"]})
    print(f"amortized20 path: {AMORTIZED20_EPOCHS} epochs, loss {loss[0]:.5f} -> {loss[-1]:.5f} "
          f"(epoch-0 rel err vs float64 {err:.1e}), best mean TVD {eng.best_mean_tvd_:.5f}, "
          f"TVD per observation {out['per_obs_tvd']}, {row['epochs_per_sec']:.2f} epochs/s "
          f"steady, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches}", flush=True)
    return launches, row


def run_warm16_path(device):
    """``run_scale_experiment(16, L=4, warm_start="marginals")``: a
    1000-epoch distillation toward the posterior's marginals product, then
    KSD from the fitted θ."""
    import torch
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.runners import run_scale_experiment

    kernels.reset_launches()
    out = run_scale_experiment(num_qubits=N, layers=WARM16_LAYERS, num_epochs=WARM16_EPOCHS,
                               warm_start="marginals", warm_start_epochs=WARM16_DISTILL_EPOCHS,
                               chunk_epochs=WARM16_CHUNK, seed=0, verbose=False, device=device)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    model, hist, warm = out["model"], out["history"], out["warm_start"]
    require(model.born_machine.backend == "circuit2d", "warm16 is not on circuit2d")
    check_launches("warm16", launches)
    D, E = WARM16_DISTILL_EPOCHS, WARM16_EPOCHS
    # The KSD run's forwards: one an epoch, the last epoch's evaluation, and
    # the best parameters' distribution at the end.
    for name, count in (("circuit2d_fwd", D + E + 2), ("circuit2d_bwd", D + E)):
        require(launches[name] == count, f"warm16 launched {name} {launches[name]}x, want "
                                         f"{count} (the distillation's {D} included)")
    require(warm["best_tvd"] < warm["tvd"][0],
            f"warm16 distillation best TVD {warm['best_tvd']} not below its first {warm['tvd'][0]}")
    loss = hist["loss_ksd"]
    require(all(math.isfinite(x) for x in loss), "warm16 loss not finite")
    require(hist["num_skipped_updates"] == 0, "warm16 skipped updates")
    eps = hist.get("epochs_per_sec_steady", hist["epochs_per_sec"])
    distill_eps = D / warm["train_seconds"]
    print(f"warm16 path: distillation TVD to the surrogate {warm['tvd'][0]:.5f} -> best "
          f"{warm['best_tvd']:.5f} in {D} epochs ({distill_eps:.1f} epochs/s), then {E} KSD "
          f"epochs, loss {loss[0]:.5f} -> {loss[-1]:.5f}, TVD {hist['tvd'][0]:.5f} -> best "
          f"{model.best_tvd_:.5f}, {eps:.1f} epochs/s steady, launches {launches}", flush=True)
    return launches, {"path": "warm16", "epochs_per_sec": eps, "launches": launches,
                      "distill_epochs_per_sec": distill_eps,
                      "distill_tvd_first": float(warm["tvd"][0]),
                      "distill_best_tvd": warm["best_tvd"], "best_tvd": model.best_tvd_}


def run_multiseed16_path(device):
    """``train_multi_seed`` on the 16-qubit workload: 4 replicas from the
    inits of seeds 0-3, each then against a one-seed run from its θ."""
    import numpy as np
    import torch
    from tensornetworks_tpu_torch.engines import train_multi_seed
    from tensornetworks_tpu_torch.models import QuantumBornMachine
    from tensornetworks_tpu_torch.ops import kernels

    bn, latent, obs = path_inputs(N)
    K = MULTISEED_SEEDS
    qbm = QuantumBornMachine(N, MULTISEED_LAYERS, ANSATZ, device=device)
    params0 = torch.stack([qbm.init(torch.Generator().manual_seed(k)) for k in range(K)])
    kw = dict(ansatz_layers=MULTISEED_LAYERS, num_epochs=MULTISEED_EPOCHS, device=device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    params, tvds, losses = train_multi_seed(bn, latent, obs, num_seeds=K, params0=params0, **kw)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check_launches("multiseed16", launches)
    require(bool(np.isfinite(losses).all()), "multiseed16 loss not finite")
    worst = 0.0
    for k in range(K):
        p1, t1, l1 = train_multi_seed(bn, latent, obs, num_seeds=1, params0=params0[k:k + 1],
                                      **kw)
        errs = (float(np.abs(l1[:, 0] - losses[:, k]).max() / np.abs(losses[:, k]).max()),
                float(np.abs(t1[:, 0] - tvds[:, k]).max() / np.abs(tvds[:, k]).max()),
                rel_err(p1[0], params[k]))
        worst = max(worst, *errs)
        require(max(errs) <= MULTISEED_TOL, f"multiseed16 replica {k} differs from its "
                                            f"one-seed run: rel errs {errs}")
    eps = MULTISEED_EPOCHS / elapsed
    print(f"multiseed16 path: {K} seeds x {MULTISEED_EPOCHS} epochs, loss "
          f"{[round(float(x), 5) for x in losses[0]]} -> {[round(float(x), 5) for x in losses[-1]]}, "
          f"final TVD {[round(float(x), 5) for x in tvds[-1]]}, replicas against one-seed runs: "
          f"max rel err {worst:.1e}, {eps:.1f} epochs/s ({K} replicas an epoch), launches "
          f"{launches}", flush=True)
    return launches, {"path": "multiseed16", "epochs_per_sec": eps, "launches": launches,
                      "loss_first": losses[0].tolist(), "loss_last": losses[-1].tolist(),
                      "tvd_last": tvds[-1].tolist(), "replica_rel_err": worst}


def work_dir(name):
    """An empty directory for a phase's files under the checkout's
    git-ignored ``build/``."""
    d = Path(__file__).resolve().parent / "build" / "chip_smoke" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


@contextlib.contextmanager
def killed_after(chunks):
    """Fault injection, as the JAX package's tests/test_chunked_resume.py
    injects it: the KSD engines' ``run_ksd_scan`` raises after saving
    ``chunks`` chunks."""
    from tensornetworks_tpu_torch.engines import ksd as ksd_mod

    orig = ksd_mod.run_ksd_scan
    ksd_mod.run_ksd_scan = lambda **kw: orig(**kw, fail_after_chunks=chunks)
    try:
        yield
    finally:
        ksd_mod.run_ksd_scan = orig


@contextlib.contextmanager
def timed_snapshots(times):
    """Seconds of each snapshot write and load of the engines, appended to
    ``times["save"]`` and ``times["load"]``."""
    from tensornetworks_tpu_torch.engines import advi, ksd as ksd_mod

    saved = {(m, f): getattr(m, f) for m in (ksd_mod, advi)
             for f in ("_save_chunk_state", "_load_chunk_state")}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            times[key].append(time.perf_counter() - t0)
            return out
        return wrapper

    for (m, f), fn in saved.items():
        setattr(m, f, timed(fn, "save" if "save" in f else "load"))
    try:
        yield
    finally:
        for (m, f), fn in saved.items():
            setattr(m, f, fn)


def require_same_checkpoints(path, a, b):
    """Two checkpoints with the same keys and every tensor equal bit for bit."""
    import torch
    from tensornetworks_tpu_torch.train import load_checkpoint

    ca, cb = load_checkpoint(a), load_checkpoint(b)
    require(set(ca) == set(cb), f"{path} checkpoints' keys differ: {sorted(ca)} {sorted(cb)}")
    for key in ca:
        require(torch.equal(ca[key], cb[key]), f"{path} checkpoints differ in {key}")
    return sorted(ca)


def require_same_runs(path, a, b):
    """Two runs' histories, final and best parameters, best TVD and epoch,
    bit for bit (a KSD engine, or the adversarial engine's Born machine and
    discriminator)."""
    import numpy as np
    import torch

    for key, col in a.history_.items():
        if isinstance(col, list):
            require(np.array_equal(col, b.history_[key], equal_nan=True),
                    f"{path} resumed history {key} differs from the uninterrupted run's")
    require((a.best_tvd_, a.best_epoch_) == (b.best_tvd_, b.best_epoch_),
            f"{path} best TVD/epoch {(b.best_tvd_, b.best_epoch_)} after the resume, "
            f"{(a.best_tvd_, a.best_epoch_)} uninterrupted")
    for name in ("params", "best_params_", "born_params", "classifier_params"):
        if hasattr(a, name):
            require(torch.equal(getattr(a, name), getattr(b, name)),
                    f"{path} {name} after the resume differs from the uninterrupted run's")


def run_cli16_path(device):
    """bn16 at full width through the command line: (a) uninterrupted in
    process, with --checkpoint A; (b) killed after 3 chunks with
    --resume-state S --checkpoint B; (c) resumed by ``python -m
    tensornetworks_tpu_torch.runners.cli`` in another process; (d) A and B
    equal bit for bit."""
    import torch
    from tensornetworks_tpu_torch.engines import ksd as ksd_mod
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.runners import cli

    d = work_dir("cli16")
    A, B, S = str(d / "a.pt"), str(d / "b.pt"), str(d / "resume.pt")
    argv = CLI16_ARGV + ["--device", str(device)]
    kernels.reset_launches()
    out = cli.main(argv + ["--checkpoint", A])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_launches("cli16", launches)
    want = {"circuit2d_fwd": CLI16_EPOCHS + 2, "circuit2d_bwd": CLI16_EPOCHS,
            "stein2d": CLI16_EPOCHS, "stein_gcorr": CLI16_EPOCHS}
    require(all(launches[k] == v for k, v in want.items()),
            f"cli16 launches {launches}, want {want}")
    hist = out["history"]
    eps = hist["epochs_per_sec_steady"]
    times = {"save": [], "load": []}
    with timed_snapshots(times), killed_after(CLI16_KILL):
        try:
            cli.main(argv + ["--resume-state", S, "--checkpoint", B])
            require(False, "cli16: the injected fault did not stop the run")
        except RuntimeError as e:
            require("fault injection" in str(e), f"cli16 run failed: {e}")
    require(os.path.exists(S) and not os.path.exists(B),
            "cli16: after the kill the snapshot must exist and the checkpoint must not")
    snapshot_bytes = os.path.getsize(S)
    fingerprint = torch.load(S, weights_only=True)["fingerprint"]
    t0 = time.perf_counter()
    ksd_mod._load_chunk_state(S, fingerprint, (), device)
    torch.cuda.synchronize()
    times["load"].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tensornetworks_tpu_torch.runners.cli",
                           *CLI16_ARGV, "--resume-state", S, "--checkpoint", B],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=600)
    t_sub = time.perf_counter() - t0
    require(proc.returncode == 0, f"cli16 resume exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    require(not os.path.exists(S), "cli16: the snapshot was not removed after the resume")
    keys = require_same_checkpoints("cli16", A, B)
    resumed = [ln for ln in proc.stdout.splitlines() if "Quantum KSD training" in ln]
    print(f"cli16 path: {CLI16_EPOCHS} epochs through the CLI, best TVD "
          f"{out['model'].best_tvd_:.5f} at epoch {out['model'].best_epoch_}, {eps:.1f} epochs/s "
          f"steady, launches {launches}; killed after {CLI16_KILL} chunks, resumed by the CLI in "
          f"another process ({t_sub:.1f}s, {resumed[-1].strip() if resumed else 'no summary'}); "
          f"checkpoints {keys} equal bit for bit; snapshot {snapshot_bytes} bytes, write "
          f"{1e3 * statistics.median(times['save']):.2f} ms (median of {len(times['save'])}), "
          f"load {1e3 * times['load'][0]:.2f} ms", flush=True)
    return launches, {"path": "cli16", "epochs_per_sec": eps, "launches": launches,
                      "best_tvd": out["model"].best_tvd_, "bit_equal": True,
                      "resume_subprocess_s": t_sub, "snapshot_bytes": snapshot_bytes,
                      "snapshot_save_ms": 1e3 * statistics.median(times["save"]),
                      "snapshot_load_ms": 1e3 * times["load"][0]}


def run_cli20_path(device):
    """scale20 with the tempered target through the command line: an
    uninterrupted run, then one killed after chunk 1 (the β = 0.5 chunk) and
    resumed in process, which trains chunk 1 on through β = 1.0."""
    import torch
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.runners import cli

    d = work_dir("cli20")
    A, B, S = str(d / "a.pt"), str(d / "b.pt"), str(d / "resume.pt")
    argv = CLI20_ARGV + ["--device", str(device)]
    kernels.reset_launches()
    ref = cli.main(argv + ["--checkpoint", A])
    times = {"save": [], "load": []}
    with timed_snapshots(times):
        with killed_after(CLI20_KILL):
            try:
                cli.main(argv + ["--resume-state", S, "--checkpoint", B])
                require(False, "cli20: the injected fault did not stop the run")
            except RuntimeError as e:
                require("fault injection" in str(e), f"cli20 run failed: {e}")
        require(os.path.exists(S) and not os.path.exists(B),
                "cli20: after the kill the snapshot must exist and the checkpoint must not")
        snapshot_bytes = os.path.getsize(S)
        out = cli.main(argv + ["--resume-state", S, "--checkpoint", B])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_launches("cli20", launches)
    require(out["model"].born_machine.backend == "circuit2d_grid", "cli20 is not on the grid")
    require(not os.path.exists(S), "cli20: the snapshot was not removed after the resume")
    require_same_runs("cli20", ref["model"], out["model"])
    keys = require_same_checkpoints("cli20", A, B)
    eps = ref["history"]["epochs_per_sec_steady"]
    print(f"cli20 path: uninterrupted and resumed after chunk {CLI20_KILL} equal bit for bit "
          f"(history, θ, best θ, best TVD {ref['model'].best_tvd_:.5f} at epoch "
          f"{ref['model'].best_epoch_}; checkpoints {keys}), {eps:.2f} epochs/s steady; snapshot "
          f"{snapshot_bytes} bytes, write {1e3 * statistics.median(times['save']):.2f} ms "
          f"(median of {len(times['save'])}), load {1e3 * times['load'][0]:.2f} ms, launches "
          f"{launches}", flush=True)
    return launches, {"path": "cli20", "epochs_per_sec": eps, "launches": launches,
                      "best_tvd": ref["model"].best_tvd_, "bit_equal": True,
                      "snapshot_bytes": snapshot_bytes,
                      "snapshot_save_ms": 1e3 * statistics.median(times["save"]),
                      "snapshot_load_ms": 1e3 * times["load"][0]}


def run_cli_adv16_path(device):
    """cli_adv16 in a process of its own: ``chip_smoke.py --cli-adv16``,
    with ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts there, as
    ``torch.use_deterministic_algorithms`` needs for cuBLAS. Its launches
    and row come back on its last line."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--cli-adv16",
                           str(device)], cwd=Path(__file__).resolve().parent, env=env,
                          capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    print("\n".join(lines[:-1]), flush=True)
    require(proc.returncode == 0, f"cli_adv16 exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    out = json.loads(lines[-1])
    return out["launches"], out["row"]


def cli_adv16_in_process(device):
    """adversarial16's model over two lr phases through the command line:
    an uninterrupted run; one killed after phase 2's first chunk; the rerun,
    which must replay phase 1 from S.phase0 without dispatching an epoch (no
    backward launched), resume phase 2 from S.phase1, remove both and end
    with the uninterrupted run's best Born and discriminator parameters.
    The REINFORCE log q gather's backward is an atomic scatter on the card,
    whose sums part runs (sampled16, PR 9), so all three runs go under
    ``torch.use_deterministic_algorithms``."""
    import torch
    from tensornetworks_tpu_torch.engines import AdversarialVariationalInference as Adv
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.runners import cli

    d = work_dir("cli_adv16")
    S = str(d / "resume.pt")
    train = Adv.train
    phases, kill = [], {"phase": None}

    def spy(self, *args, **kwargs):
        if len(phases) + 1 == kill["phase"]:
            kwargs["fail_after_chunks"] = 1
        before = dict(kernels.LAUNCHES)
        try:
            out = train(self, *args, **kwargs)
        finally:
            phases.append({k: kernels.LAUNCHES[k] - before[k] for k in before})
        phases[-1]["epochs_dispatched"] = out["epochs_dispatched"]
        return out

    argv = CLI_ADV16_ARGV + ["--device", str(device)]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    Adv.train = spy
    try:
        kernels.reset_launches()
        ref = cli.main(argv)["model"]
        kill["phase"] = 2
        phases.clear()
        try:
            cli.main(argv + ["--resume-state", S])
            require(False, "cli_adv16: the injected fault did not stop the run")
        except RuntimeError as e:
            require("fault injection" in str(e), f"cli_adv16 run failed: {e}")
        require(os.path.exists(S + ".phase0") and os.path.exists(S + ".phase1"),
                "cli_adv16: after the kill both phases' snapshots must exist")
        kill["phase"] = None
        phases.clear()
        out = cli.main(argv + ["--resume-state", S])["model"]
    finally:
        Adv.train = train
        torch.use_deterministic_algorithms(was)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_launches("cli_adv16", launches)
    replay, resumed = phases
    require(replay["epochs_dispatched"] == 0 and replay["circuit2d_bwd"] == 0,
            f"cli_adv16: phase 1 was not replayed from its snapshot: {replay}")
    require(resumed["epochs_dispatched"] == CLI_ADV16_PHASE_EPOCHS - CLI_ADV16_CHUNK,
            f"cli_adv16: phase 2 dispatched {resumed['epochs_dispatched']} epochs")
    require(not any(os.path.exists(f"{S}.phase{i}") for i in range(2)),
            "cli_adv16: the phases' snapshots were not removed")
    require(ref.best_tvd_ == out.best_tvd_, f"cli_adv16 best TVD {out.best_tvd_} after the "
                                            f"rerun, {ref.best_tvd_} uninterrupted")
    for name in ("born_params", "classifier_params"):
        require(torch.equal(getattr(ref, name), getattr(out, name)),
                f"cli_adv16 best {name} after the rerun differs from the uninterrupted run's")
    print(f"cli_adv16 path: two phases of {CLI_ADV16_PHASE_EPOCHS} epochs, best TVD "
          f"{ref.best_tvd_:.5f}; the rerun replayed phase 1 from its snapshot ({replay}) and "
          f"resumed phase 2 ({resumed}); best Born and discriminator parameters equal bit for "
          f"bit; launches {launches}", flush=True)
    return launches, {"path": "cli_adv16", "launches": launches, "best_tvd": ref.best_tvd_,
                      "bit_equal": True, "phase1_replay": replay, "phase2_resumed": resumed}


def run_profile16_path(device):
    """main16's engine for 2 chunks of 25 epochs with ``profile_dir``: the
    trace must name the __global__ functions of kernels 1, 2, 3 and
    stein_gcorr (the ctypes launches are seen by the profiler)."""
    import torch
    from tensornetworks_tpu_torch.engines import QuantumKSDVariationalInference
    from tensornetworks_tpu_torch.ops import kernels

    d = work_dir("profile16")
    bn, latent, obs = path_inputs(N)
    eng = QuantumKSDVariationalInference(bn, latent, list(obs), qbm_num_latent_vars=N,
                                         qbm_ansatz_layers=LAYERS, qbm_ansatz_type=ANSATZ,
                                         seed=0, device=device)
    kernels.reset_launches()
    hist = eng.train(obs, num_epochs=PROFILE16_EPOCHS, lr_born_machine=5e-3, verbose=False,
                     true_posterior_for_tvd=bn.posterior_vector(latent, obs),
                     chunk_epochs=PROFILE16_CHUNK, profile_dir=str(d))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_launches("profile16", launches)
    traces = sorted(d.glob("*.pt.trace.json"))
    require(len(traces) == 1, f"profile16 wrote {len(traces)} traces to {d}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    device_events = [e for e in events if e.get("cat") == "kernel"]
    found = {}
    for k in PROFILE16_KERNELS:
        hits = [e for e in device_events if k in e.get("name", "")]
        require(hits, f"profile16: no device event names {k} "
                      f"({len(device_events)} device kernel events in the trace)")
        found[k] = {"events": len(hits), "device_us": sum(e.get("dur", 0) for e in hits)}
    eps = hist["epochs_per_sec"]
    print(f"profile16 path: {PROFILE16_EPOCHS} epochs under the profiler at {eps:.1f} epochs/s, "
          f"trace {traces[0].name} ({traces[0].stat().st_size} bytes, {len(device_events)} "
          f"device kernel events), kernels {found}, launches {launches}", flush=True)
    return launches, {"path": "profile16", "epochs_per_sec": eps, "launches": launches,
                      "trace_bytes": traces[0].stat().st_size,
                      "device_kernel_events": len(device_events), "kernels": found}


def run_state_path(path, n, device):
    """``QuantumBornMachine.state`` (HE L=4) from the forward kernel's final
    planes: |state|² against ``probs`` of the same θ (FP32), and state
    against the float64 blocked executor's state of the same θ."""
    import torch
    from tensornetworks_tpu_torch.models import QuantumBornMachine
    from tensornetworks_tpu_torch.ops import kernels

    qbm = QuantumBornMachine(n, LAYERS, ANSATZ, device=device)
    require(qbm.backend == ("circuit2d" if n <= 17 else "circuit2d_grid"),
            f"{path} runs {qbm.backend}")
    theta = qbm.init(torch.Generator().manual_seed(3))
    kernels.reset_launches()
    st = qbm.state(theta)
    with torch.no_grad():
        probs = qbm.probs(theta)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_launches(path, launches)
    require(st.shape == (2,) * n and st.dtype == torch.complex64, f"{path} state {st.shape}")
    probs_err = float((st.abs().reshape(-1) ** 2 - probs).abs().max())
    probs_rel = probs_err / float(probs.max())
    ref = QuantumBornMachine(n, LAYERS, ANSATZ, backend="blocked", dtype=torch.float64,
                             device=device).state(theta.double())
    f64_err = rel_err(st.to(torch.complex128), ref)
    require(probs_err <= STATE_TOL_PROBS and probs_rel <= STATE_TOL_PROBS_REL,
            f"{path} |state|² {probs_err:.1e} from probs ({probs_rel:.1e} of the largest)")
    require(f64_err <= STATE_TOL_F64, f"{path} state {f64_err:.1e} from float64 (relative)")
    print(f"{path}: state from {qbm.backend}'s forward kernel, |state|^2 - probs max abs "
          f"{probs_err:.1e} (limit {STATE_TOL_PROBS}), {probs_rel:.1e} of the largest "
          f"probability (limit {STATE_TOL_PROBS_REL}), against the float64 blocked state "
          f"{f64_err:.1e} relative (limit {STATE_TOL_F64}), launches {launches}", flush=True)
    return launches, {"path": path, "launches": launches, "probs_max_abs_err": probs_err,
                      "probs_rel_err": probs_rel,
                      "f64_rel_err": f64_err}


def check_rank_launches(path, reports, want):
    """Every rank launched the path's kernel set and no other kernel, each
    kernel of ``want`` exactly so many times."""
    for r in reports:
        check_launches(path, r["launches"])
        for name, count in want.items():
            require(r["launches"][name] == count,
                    f"{path} rank {r['rank']} launched {name} {r['launches'][name]}x, want {count}")


def max_rel_diff(a, b):
    import numpy as np

    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def within(path, what, got, want):
    """``got`` against the single-device ``want`` at the mesh phases'
    tolerance (rtol ``MESH_RTOL``, atol ``MESH_ATOL``); the largest
    difference."""
    import numpy as np

    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    diff = np.abs(got - want)
    require(bool(np.all(diff <= MESH_ATOL + MESH_RTOL * np.abs(want))),
            f"{path} {what} differs from the single-device run by {diff.max():.2e}")
    return float(diff.max())


def dist_row(path, reports, epochs, rate, extra):
    """A row of the ``{"distributed": [...]}`` line: the transport, the rate,
    each rank's peak device memory, launches and collective bytes an epoch."""
    return {"path": path, "ranks": len(reports), "transport": reports[0]["transport"],
            "epochs_per_sec": rate,
            "peak_gib_per_rank": [(r["peak_bytes"] or 0) / 2**30 for r in reports],
            "launches_per_rank": [r["launches"] for r in reports],
            "comm_bytes_per_epoch": [{k: v / epochs for k, v in r["comm_bytes"].items()}
                                     for r in reports]} | extra


def print_dist(path, row, detail):
    comm = row["comm_bytes_per_epoch"][0]
    print(f"{path} path: {row['ranks']} rank(s) over {row['transport']}, {detail}, "
          f"{row['epochs_per_sec']:.2f} epochs/s, peak "
          f"{max(row['peak_gib_per_rank']):.2f} GiB a rank, collective bytes an epoch on "
          f"rank 0 {', '.join(f'{k} {v:,.0f}' for k, v in comm.items())}, launches per rank "
          f"{[r for r in row['launches_per_rank']]}", flush=True)


def run_dist20_path(device, scale20_hist):
    """scale20's configuration through ``cli scale --mesh 1`` on nccl: kernel 4
    once an epoch (the custom backward reuses the forward matvec), epoch 0
    against float64, the history against the single-device scale20 run from
    the same θ0."""
    import torch
    from tensornetworks_tpu_torch.models import QuantumBornMachine
    from tensornetworks_tpu_torch.runners import cli

    theta0 = QuantumBornMachine(N_GRID, LAYERS, ANSATZ, device=device).init(
        torch.Generator().manual_seed(0))
    out = cli.main(DIST20_ARGV + ["--mesh", "1"])
    reports, hist = out["ranks"], out["history"]
    require([r["transport"] for r in reports] == ["nccl"], f"dist20 ran over {reports}")
    check_rank_launches("dist20", reports, {"stein2d_grid": DIST20_EPOCHS})
    check_history("dist20", hist)
    loss = hist["loss_ksd"]
    ref = scale20_reference_loss(theta0)
    err0 = abs(loss[0] - ref) / abs(ref)
    require(err0 < 1e-4, f"dist20 epoch-0 loss {loss[0]} vs float64 {ref}")
    rel = max_rel_diff(loss, scale20_hist["loss_ksd"])
    require(rel < DIST20_TOL, f"dist20 loss history {rel:.2e} from scale20's (relative)")
    rate = hist.get("epochs_per_sec_steady", hist["epochs_per_sec"])
    row = dist_row("dist20", reports, DIST20_EPOCHS, rate,
                   {"loss_first": loss[0], "loss_last": loss[-1], "epoch0_rel_err": err0,
                    "rel_diff_scale20": rel, "best_tvd": out["best_tvd"]})
    print_dist("dist20", row, f"{DIST20_EPOCHS} epochs, loss {loss[0]:.5f} -> {loss[-1]:.5f} "
               f"(epoch 0 {err0:.1e} from float64, history {rel:.1e} from scale20), best TVD "
               f"{out['best_tvd']:.5f}")
    return reports[0]["launches"], row, hist


def dist20x4_killed_rank(kwargs):
    """A dist20x4 rank whose engine raises after its first chunk's snapshot
    (the fault injected into the engine module's ``run_ksd_scan``)."""
    from tensornetworks_tpu_torch.engines import distributed as dist_engine
    from tensornetworks_tpu_torch.runners import run_distributed_scale_experiment

    orig = dist_engine.run_ksd_scan
    dist_engine.run_ksd_scan = lambda **kw: orig(**kw, fail_after_chunks=DIST20_KILL)
    return run_distributed_scale_experiment(**kwargs)


def run_dist20x4_path(device, dist20_hist):
    """dist20 on 4 gloo ranks of the one card: the history against dist20;
    then killed after its first chunk and resumed by the CLI, bit for bit
    the uninterrupted run."""
    import torch
    from torch.multiprocessing import ProcessRaisedException
    from tensornetworks_tpu_torch.parallel import spawn
    from tensornetworks_tpu_torch.runners import cli

    argv = DIST20_ARGV + ["--mesh", str(DIST_RANKS), "--dist-backend", "gloo"]
    full = cli.main(argv)
    reports, hist = full["ranks"], full["history"]
    require([r["transport"] for r in reports] == ["gloo via host"] * DIST_RANKS,
            f"dist20x4 ran over {[r['transport'] for r in reports]}")
    check_rank_launches("dist20x4", reports, {"stein2d_grid": DIST20_EPOCHS})
    check_history("dist20x4", hist)
    rel = max_rel_diff(hist["loss_ksd"], dist20_hist["loss_ksd"])
    require(rel < DIST20X4_TOL, f"dist20x4 loss history {rel:.2e} from dist20's (relative)")
    state = work_dir("dist20x4") / "resume.pt"
    kw = dict(num_qubits=N_GRID, layers=LAYERS, num_epochs=DIST20_EPOCHS, chunk_epochs=DIST20_CHUNK,
              verbose=False, resume_state_path=str(state), device=device.type)
    try:
        spawn(dist20x4_killed_rank, DIST_RANKS, "gloo", device, kw, timeout_s=DIST_TIMEOUT_S)
        killed = False
    except ProcessRaisedException as e:
        killed = "fault injection" in str(e)
    require(killed and state.exists(), "dist20x4 was not killed after its first chunk with a "
                                       "snapshot left")
    resumed = cli.main(argv + ["--resume-state", str(state)])
    require(not state.exists(), "dist20x4's snapshot is still there after the resumed run")
    check_rank_launches("dist20x4", resumed["ranks"],
                        {"stein2d_grid": DIST20_EPOCHS - DIST20_KILL * DIST20_CHUNK})
    for key in ("loss_ksd", "tvd", "grad_norm"):
        a, b = hist[key], resumed["history"][key]
        parted = [t for t, (x, y) in enumerate(zip(a, b)) if x != y]
        require(not parted, f"dist20x4 resumed {key} parts from the uninterrupted run's at "
                            f"epoch {parted[:1]}")
    require((full["best_tvd"], full["best_epoch"]) == (resumed["best_tvd"], resumed["best_epoch"]),
            "dist20x4 resumed best TVD/epoch differ")
    for key in ("params", "best_params"):
        require(torch.equal(full[key], resumed[key]), f"dist20x4 resumed {key} differ")
    rate = hist.get("epochs_per_sec_steady", hist["epochs_per_sec"])
    loss = hist["loss_ksd"]
    row = dist_row("dist20x4", reports, DIST20_EPOCHS, rate,
                   {"loss_first": loss[0], "loss_last": loss[-1], "rel_diff_dist20": rel,
                    "best_tvd": full["best_tvd"], "resume_bit_equal": True})
    print_dist("dist20x4", row, f"{DIST20_EPOCHS} epochs, loss {loss[0]:.5f} -> {loss[-1]:.5f} "
               f"(history {rel:.1e} from dist20), killed after chunk {DIST20_KILL} and resumed: "
               f"history, θ, best θ, best TVD and epoch equal bit for bit")
    return reports[0]["launches"], row


def _all_ranks_equal(t) -> bool:
    import torch.distributed as dist

    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, t.detach().cpu())
    return all(g.equal(got[0]) for g in got)


def _dist_sampled_rank(device):
    from tensornetworks_tpu_torch.engines import DistributedSampledKSDVariationalInference
    from tensornetworks_tpu_torch.engines import distributed_sampled as ds
    from tensornetworks_tpu_torch.parallel import make_mesh

    bn, latent, obs = path_inputs(N_GRID)
    shots = []
    orig = ds.make_distributed_two_stage_sampler

    def recording(*args, **kwargs):
        sample = orig(*args, **kwargs)

        def record(P2l, u_r, u_c):
            idx, q_at = sample(P2l, u_r, u_c)
            shots.append((idx.cpu(), u_r.cpu(), u_c.cpu()))
            return idx, q_at
        return record

    ds.make_distributed_two_stage_sampler = recording
    try:
        eng = DistributedSampledKSDVariationalInference(
            bn, latent, list(obs), qbm_ansatz_layers=LAYERS, num_samples=DIST_SAMPLED_SHOTS,
            seed=0, mesh=make_mesh(DIST_RANKS), device=device)
        thetas, probs = [], eng._probs  # θ of each epoch's loss forward
        eng._probs = lambda p: (thetas.append(p.detach().cpu()), probs(p))[1]
        hist = eng.train(obs, num_epochs=DIST_SAMPLED_EPOCHS, lr_born_machine=DIST_SAMPLED_LR,
                         verbose=False, true_posterior_for_tvd=bn.posterior_vector(latent, obs),
                         reuse_loss_forward_for_eval=True)
    finally:
        ds.make_distributed_two_stage_sampler = orig
    return {"history": hist, "shots": shots, "thetas": thetas[:DIST_SAMPLED_EPOCHS],
            "best_tvd": eng.best_tvd_, "params_equal": _all_ranks_equal(eng.params),
            "epochs": DIST_SAMPLED_EPOCHS}


def _amortized_mesh_rank(device):
    from tensornetworks_tpu_torch.parallel import make_mesh

    eng, observations = amortized16_engine(device)
    hist = eng.train(observations, num_epochs=AMORTIZED_MESH_EPOCHS, lr=AMORTIZED16_LR,
                     gradient_clip_norm=10.0, entropy_weight=0.0, verbose=False, seed=0,
                     mesh=make_mesh(DIST_RANKS, dp=DIST_RANKS))
    return {"history": hist, "best": eng.best_mean_tvd_, "params_equal": _all_ranks_equal(
        eng.params), "epochs": AMORTIZED_MESH_EPOCHS}


def _multiseed_mesh_rank(device):
    from tensornetworks_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    params, tvds, losses = multiseed16_run(device, mesh=make_mesh(DIST_RANKS, dp=DIST_RANKS))
    synchronize(device)
    return {"tvds": tvds, "losses": losses, "params": params.cpu(),
            "epochs_per_sec": MULTISEED_MESH_EPOCHS / (time.perf_counter() - t0),
            "epochs": MULTISEED_MESH_EPOCHS}


DIST_RANK_PHASES = (("dist_sampled20x4", _dist_sampled_rank),
                    ("amortized_mesh16x4", _amortized_mesh_rank),
                    ("multiseed_mesh16x4", _multiseed_mesh_rank))


def synchronize(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dist_phases_rank(device):
    """One rank of the three phases that share a 4-rank gloo world: each
    phase with the launch and byte counts and the peak memory zeroed just
    before it, every rank's counters gathered just after."""
    import torch
    import torch.distributed as dist
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.parallel import comm
    from tensornetworks_tpu_torch.parallel.launch import gather_reports, local_device

    device = local_device(device)
    out = {}
    for path, run in DIST_RANK_PHASES:
        synchronize(device)
        dist.barrier()
        kernels.reset_launches()
        comm.reset_bytes()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        result = run(device)
        synchronize(device)
        result["seconds"] = time.perf_counter() - t0
        out[path] = {"result": result, "ranks": gather_reports(device)}
    return out


def amortized16_engine(device):
    """amortized16's engine (seed 0) and its 4 observations."""
    from tensornetworks_tpu_torch.engines import AmortizedKSD
    from tensornetworks_tpu_torch.models import QuantumBornMachine
    from tensornetworks_tpu_torch.sim import latent_edges

    bn, latent, observed, observations = amortized16_problem()
    qbm = QuantumBornMachine(N, BN_LAYERS, BN, device=device, edges=latent_edges(bn, latent),
                             conditioning_dim=len(observed), cond_reupload=True)
    require(qbm.backend == "circuit2d", f"amortized16 is on {qbm.backend}, not circuit2d")
    return AmortizedKSD(bn, latent, observed, born_machine=qbm, seed=0,
                        base_kernel_length_scale="auto"), observations


def multiseed16_run(device, num_epochs=MULTISEED_MESH_EPOCHS, mesh=None):
    """``train_multi_seed`` on the 16-qubit workload from the inits of seeds
    0-3 (HE L=2)."""
    import torch
    from tensornetworks_tpu_torch.engines import train_multi_seed
    from tensornetworks_tpu_torch.models import QuantumBornMachine

    bn, latent, obs = path_inputs(N)
    qbm = QuantumBornMachine(N, MULTISEED_LAYERS, ANSATZ, device=device)
    params0 = torch.stack([qbm.init(torch.Generator().manual_seed(k))
                           for k in range(MULTISEED_SEEDS)])
    return train_multi_seed(bn, latent, obs, num_seeds=MULTISEED_SEEDS, params0=params0,
                            ansatz_layers=MULTISEED_LAYERS, num_epochs=num_epochs, device=device,
                            mesh=mesh)


def run_dist_rank_phases(device):
    """dist_sampled20x4, amortized_mesh16x4 and multiseed_mesh16x4 in one
    4-rank gloo world on the card, each against its single-device run in
    this process."""
    import numpy as np
    import torch
    from tensornetworks_tpu_torch.core.bits import torch_index_to_bits
    from tensornetworks_tpu_torch.core.factors import make_latent_log_joint_fn
    from tensornetworks_tpu_torch.engines import SampledKSDVariationalInference
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.ops.stein_sampled import (ksd_ustat, score_at_samples,
                                                            stein_gram_samples)
    from tensornetworks_tpu_torch.parallel import spawn
    from tensornetworks_tpu_torch.sim.sampling import sample_indices_2d, step_distances

    got = spawn(dist_phases_rank, DIST_RANKS, "gloo", device, str(device.type),
                timeout_s=DIST_TIMEOUT_S)
    launches, rows = {}, []

    path = "dist_sampled20x4"
    res, reports = got[path]["result"], got[path]["ranks"]
    check_rank_launches(path, reports, {})
    h2 = res["history"]
    require(all(math.isfinite(x) for x in h2["loss_ksd"]) and h2["num_skipped_updates"] == 0,
            f"{path} loss not finite or updates skipped")
    require(res["params_equal"], f"{path} θ differs between the ranks")
    # The single-device engine at the ranks' θ of each epoch, on the ranks'
    # uniforms: its forward (kernel 5), two-stage shots and U-statistic.
    bn, latent, obs = path_inputs(N_GRID)
    single = SampledKSDVariationalInference(bn, latent, list(obs), qbm_ansatz_layers=LAYERS,
                                            num_samples=DIST_SAMPLED_SHOTS, seed=0,
                                            sampling="two_stage", device=device)
    log_joint = make_latent_log_joint_fn(bn, latent, obs, device=device)
    R, C = 1 << ((N_GRID + 1) // 2), 1 << (N_GRID // 2)
    ties, worst, rel = 0, 0.0, 0.0
    kernels.reset_launches()
    for epoch, (theta, (idx2, u_r, u_c)) in enumerate(zip(res["thetas"], res["shots"])):
        u_r, u_c = u_r.to(device), u_c.to(device)
        with torch.no_grad():
            P = single.born_machine.probs(theta.to(device)).to(torch.float32).reshape(R, C)
        idx1 = sample_indices_2d(P, u_r, u_c)[0]
        d = step_distances(P, idx1, idx2.to(device), u_r, u_c)
        require(bool(np.all(d <= DIST_TIE_DISTANCE)),
                f"{path} epoch {epoch}: shots differ from the single engine's off a tie: {d}")
        ties += len(d)
        worst = max([worst, *d])
        if len(d) == 0:  # the same shots: the same U-statistic
            Z = torch_index_to_bits(idx1, N_GRID, dtype=torch.float32)
            gram = stein_gram_samples(score_at_samples(log_joint, Z), Z, N_GRID,
                                      single.length_scale)
            est = float(ksd_ustat(gram))
            rel = max(rel, abs(h2["loss_ksd"][epoch] - est) / abs(est))
    require(kernels.LAUNCHES["circuit_gates_fwd"] == DIST_SAMPLED_EPOCHS,
            f"{path}: the single engine's forward did not run kernel 5 once an epoch")
    require(rel < DIST_SAMPLED_TOL, f"{path} U-statistics {rel:.2e} from the single engine's")
    rate = DIST_SAMPLED_EPOCHS / h2["train_seconds"]
    rows.append(dist_row(path, reports, DIST_SAMPLED_EPOCHS, rate,
                         {"shots": DIST_SAMPLED_SHOTS, "fp32_ties": ties, "tie_max": worst,
                          "rel_diff_single": rel, "loss_first": h2["loss_ksd"][0],
                          "loss_last": h2["loss_ksd"][-1], "best_tvd": res["best_tvd"]}))
    print_dist(path, rows[-1], f"{DIST_SAMPLED_EPOCHS} epochs of {DIST_SAMPLED_SHOTS} shots; at "
               f"each epoch's θ the single engine's shots on the same uniforms ({ties} FP32 CDF "
               f"ties, largest distance {worst:.1e}) and U-statistic ({rel:.1e} relative), "
               f"U-statistic {h2['loss_ksd'][0]:.4f} -> {h2['loss_ksd'][-1]:.4f}")
    launches[path] = reports[0]["launches"]

    path = "amortized_mesh16x4"
    res, reports = got[path]["result"], got[path]["ranks"]
    eng, observations = amortized16_engine(device)
    kernels.reset_launches()
    h1 = eng.train(observations, num_epochs=AMORTIZED_MESH_EPOCHS, lr=AMORTIZED16_LR,
                   gradient_clip_norm=10.0, entropy_weight=0.0, verbose=False, seed=0)
    synchronize(device)
    single_launches = dict(kernels.LAUNCHES)
    check_rank_launches(path, reports, {k: v // DIST_RANKS for k, v in single_launches.items()})
    h2 = res["history"]
    errs = [within(path, key, h2[key], h1[key]) for key in ("loss", "mean_tvd")]
    require(res["params_equal"], f"{path} θ differs between the ranks")
    rows.append(dist_row(path, reports, AMORTIZED_MESH_EPOCHS, h2["epochs_per_sec"],
                         {"max_abs_diff_loss": errs[0], "max_abs_diff_mean_tvd": errs[1],
                          "best_mean_tvd": res["best"], "single_best_mean_tvd": eng.best_mean_tvd_,
                          "single_launches": single_launches}))
    print_dist(path, rows[-1], f"{AMORTIZED_MESH_EPOCHS} epochs, one observation a rank, loss "
               f"and mean TVD {errs[0]:.1e} and {errs[1]:.1e} from the single-device run "
               f"(best mean TVD {res['best']:.5f} and {eng.best_mean_tvd_:.5f}), a quarter of "
               f"its launches {single_launches}")
    launches[path] = reports[0]["launches"]

    path = "multiseed_mesh16x4"
    res, reports = got[path]["result"], got[path]["ranks"]
    kernels.reset_launches()
    _, tvds, losses = multiseed16_run(device)
    synchronize(device)
    single_launches = dict(kernels.LAUNCHES)
    check_rank_launches(path, reports, {k: v // DIST_RANKS for k, v in single_launches.items()})
    errs = [within(path, "losses", res["losses"], losses),
            within(path, "TVDs", res["tvds"], tvds)]
    rows.append(dist_row(path, reports, MULTISEED_MESH_EPOCHS, res["epochs_per_sec"],
                         {"max_abs_diff_loss": errs[0], "max_abs_diff_tvd": errs[1],
                          "single_launches": single_launches}))
    print_dist(path, rows[-1], f"{MULTISEED_SEEDS} seeds x {MULTISEED_MESH_EPOCHS} epochs, one "
               f"seed a rank, losses and TVDs {errs[0]:.1e} and {errs[1]:.1e} from the "
               f"single-device run, a quarter of its launches {single_launches}")
    launches[path] = reports[0]["launches"]
    return launches, rows


# ------------------------------------------------------------ precision (16)


def bound_bf16(flops, nbytes):
    """The bound of a bf16 tensor-core variant: its passes' FLOPs over the
    dense bf16 peak, or its bytes over the HBM rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_precision_kernels(device):
    """precision_kernels: kernel 2's bf16 launch plan against its CPU
    mirror; each bf16 variant of kernels 1, 2, 5 and 6 against its plain
    emulation on the card and against float64 without rounding, timed
    beside the FP32 kernel, at PRECISION_CASES; then untimed at
    BF16_CIRCUIT_CASES (kernels 1-2) and at n = 18, 19, 21 and 22 (kernels
    5-6). Returns one record a variant and timed case."""
    import torch

    check_bf16_plans(device)
    records = []
    for case in PRECISION_CASES:
        records += check_precision_case(device, *case, timed=True)
        torch.cuda.empty_cache()
    for n, ansatz in BF16_CIRCUIT_CASES:
        check_precision_case(device, n, False, ansatz, LAYERS, timed=False)
    for n in (N_GRID_MIN, N_GRID_ODD, N_GRID_WIDE, N_EXACT22):
        check_precision_case(device, n, True, ANSATZ, LAYERS, timed=False)
    return records


def check_bf16_plans(device):
    """The plan the library launches kernel 2's bf16 variants with
    (``tn_circuit2d_bwd_bf16_plan``) equals ``bf16_plan``, the mirror the CPU
    tests check the units of, at n = 2..17 under both bf16 precisions, on
    this card's SMs and on the H100 SXM's (``BF16_SMS``)."""
    import torch
    from tensornetworks_tpu_torch.ops.kernels import circuit2d as kc

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for count in sorted({sms, kc.BF16_SMS}):
        for prec in ("high", "default"):
            for n in range(2, 18):
                lib, mirror = kc.library_bf16_plan(n, prec, count), kc.bf16_plan(n, prec, count)
                require(lib == mirror, f"bf16 plan n={n} {prec} sms={count}: library {lib}, "
                        f"mirror {mirror}")
    print(f"bf16_plans: the library's kernel 2 plans equal bf16_plan at n = 2..17, high and "
          f"default, {sorted({sms, kc.BF16_SMS})} SMs", flush=True)


def check_precision_case(device, n, grid, ansatz, layers, timed):
    """One shape of check_precision_kernels."""
    import torch
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.ops.kernels import _lib
    from tensornetworks_tpu_torch.ops.kernels import circuit2d as kc
    from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg
    from tensornetworks_tpu_torch.sim.ansatz import num_ansatz_params
    from tensornetworks_tpu_torch.sim.gates import rotation_operators

    t0 = time.perf_counter()
    edges = path_edges(n) if ansatz == BN else None
    if grid:
        name, Plan = "circuit2d_grid", kg.GridPlan
        fwd, bwd = kg.circuit2d_grid_forward, kg.circuit2d_grid_backward
        fwd_p, bwd_p = kg.circuit2d_grid_forward_plain, kg.circuit2d_grid_backward_plain
    else:
        name, Plan = "circuit2d", kc.CircuitPlan
        fwd, bwd = kc.circuit2d_forward, kc.circuit2d_backward
        fwd_p, bwd_p = kc.circuit2d_forward_plain, kc.circuit2d_backward_plain
    plan32 = Plan(n, layers, ansatz, edges, precision="highest")
    gen = torch.Generator().manual_seed(n)
    theta = (0.1 * torch.randn(num_ansatz_params(n, layers, ansatz), generator=gen)).to(device)
    Mr, Mc = rotation_operators(theta, n, layers, plan32.per_qubit)
    planes = (kg.grid_planes(Mr, Mc, plan32) if grid
              else [t.contiguous() for t in (Mr.real, Mr.imag, Mc.real, Mc.imag)])
    del Mr, Mc
    R, C = plan32.R, plan32.C
    g = torch.randn((R, C), generator=gen).to(device) * R * C
    p64 = [t.double() for t in planes]
    f64 = fwd_p(*p64, plan32)
    ref = {"fwd": f64, "bwd": bwd_p(*p64, f64[1], f64[2], g.double(), plan32)}
    del p64, f64
    if timed:
        t = time_ms if n < N_EXACT22 else functools.partial(time_ms, reps=1, rounds=1)
        out32 = fwd(*planes, plan32)
        ms32 = {"fwd": t(lambda: fwd(*planes, plan32)),
                "bwd": t(lambda: bwd(*planes, out32[1], out32[2], g, plan32))}
        del out32
    dense = R * R * C + R * C * C
    moved = {"fwd": 4 * (2 * layers * R * R + 2 * layers * C * C + 3 * R * C),
             "bwd": 4 * (4 * layers * R * R + 4 * layers * C * C + 3 * R * C)}
    records = []
    for prec in ("default", "high"):
        plan = Plan(n, layers, ansatz, edges, precision=prec)
        before = dict(kernels.LAUNCHES)
        out_k, out_p = fwd(*planes, plan), fwd_p(*planes, plan)
        got = {"fwd": out_k, "bwd": bwd(*planes, out_k[1], out_k[2], g, plan)}
        plain = {"fwd": out_p, "bwd": bwd_p(*planes, out_p[1], out_p[2], g, plan)}
        torch.cuda.synchronize()
        calls = {"fwd": (lambda: fwd(*planes, plan), lambda: fwd_p(*planes, plan)),
                 "bwd": (lambda: bwd(*planes, out_k[1], out_k[2], g, plan),
                         lambda: bwd_p(*planes, out_p[1], out_p[2], g, plan))}
        for kind in ("fwd", "bwd"):
            key = _lib.launch_key(f"{name}_{kind}", prec)
            what = f"{key} n={n} {ansatz} L={layers}"
            require(kernels.LAUNCHES[key] > before[key], f"{key} did not launch")
            require(all(bool(torch.isfinite(x).all()) for x in got[kind]), f"{what}: not finite")
            if not grid:  # kernels 1-2: a call repeats bit for bit
                for _ in range(BF16_REPEATS - 1):
                    again = calls[kind][0]()
                    require(all(bool(torch.equal(a, b)) for a, b in zip(again, got[kind])),
                            f"{what}: a repeated call differs")
            err = max(rel_err(a, b) for a, b in zip(got[kind], plain[kind]))
            abs_err = max(float((a - b).abs().max()) for a, b in zip(got[kind], plain[kind]))
            tol = PRECISION_TOL[prec]
            require(err <= tol, f"{what}: rel err vs its plain emulation {err:.3e}")
            err64 = max(rel_err(a.double(), b) for a, b in zip(got[kind], ref[kind]))
            plain64 = max(rel_err(a.double(), b) for a, b in zip(plain[kind], ref[kind]))
            if prec == "high":
                lim64 = tol if grid else PRECISION_F64_TOL_HIGH.get((n, ansatz), tol)
                require(err64 <= lim64, f"{what}: rel err vs float64 {err64:.3e}")
            if not timed:
                same = ", 3 calls bit-equal" if not grid else ""
                print(f"{what}: rel vs plain emulation {err:.2e} (abs {abs_err:.2e}, limit "
                      f"{tol:g}), vs float64 {err64:.2e} (the emulation's {plain64:.2e}){same}",
                      flush=True)
                continue
            flops = (8 if kind == "fwd" else 24) * layers * dense * PASSES[prec]
            bound_ms, bound_by = bound_bf16(flops, moved[kind])
            ms = t(calls[kind][0])
            rec = dict(name=key, n=n, ansatz=ansatz, layers=layers, max_abs_err=abs_err,
                       rel_err=err, rel_err_f64=err64, plain_rel_err_f64=plain64, ms=ms,
                       fp32_ms=ms32[kind], plain_ms=t(calls[kind][1]), bound_ms=bound_ms,
                       bound_by=bound_by, share=bound_ms / ms, library_ms=None, tol=tol)
            records.append(rec)
            print(f"{what}: rel vs plain emulation {err:.2e} (abs {abs_err:.2e}, limit "
                  f"{tol:g}), vs float64 {err64:.2e} (the emulation's {plain64:.2e}); "
                  f"{ms:.5f} ms queued, FP32 kernel {ms32[kind]:.5f} ms, plain "
                  f"{rec['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}, "
                  f"{PASSES[prec]} pass{'es' if PASSES[prec] > 1 else ''} at "
                  f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s), share {rec['share']:.1%}",
                  flush=True)
        del out_k, out_p, got, plain, calls
    if timed:
        print(f"  (precision_kernels n={n} {ansatz}: {time.perf_counter() - t0:.1f}s)",
              flush=True)
    return records


def check_wgmma_products(device):
    """wgmma_products: each product pattern of kernels 5-6 alone on the
    Hopper loop (``circuit2d_grid.grid_product``) at WGMMA_PRODUCT_NS under
    ``high`` and ``default``: against its plain extended-K emulation (the
    variants' limits) and float64 (``high``'s limit), timed on pre-split
    planes against its bound and against ``torch.matmul`` on bf16 planes of
    the same shapes (4 real GEMMs a pass, the per-product yardstick).
    Returns one record a product."""
    import torch
    from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg

    records = []
    for n in WGMMA_PRODUCT_NS:
        t = time_ms if n < N_EXACT22 else functools.partial(time_ms, reps=5, rounds=3)
        for pattern in kg.PRODUCT_PATTERNS:
            case = kg.product_case(pattern, n, device, seed=n)
            ref, ref_probs = kg.grid_product_plain(case, "highest", dtype=torch.float64)
            for prec in ("high", "default"):
                got, probs = (x if x is None else x.clone() for x in kg.grid_product(case, prec))
                emu, emu_probs = kg.grid_product_plain(case, prec)
                torch.cuda.synchronize()
                what = f"wgmma product {pattern} n={n} {prec}"
                err, err64 = rel_err(got, emu), rel_err(got.double(), ref)
                if probs is not None:
                    err = max(err, rel_err(probs, emu_probs))
                    err64 = max(err64, rel_err(probs.double(), ref_probs))
                tol = PRECISION_TOL[prec]
                require(all(bool(torch.isfinite(x).all()) for x in (got, emu)),
                        f"{what}: not finite")
                require(err <= tol, f"{what}: rel err vs its emulation {err:.3e}")
                if prec == "high":
                    require(err64 <= tol, f"{what}: rel err vs float64 {err64:.3e}")
                split = case.get("split")  # the kernel's bf16 planes, split once
                ms = t(lambda: kg.grid_product(case, prec, split=split))
                M, N_, K, batch = case["M"], case["N"], case["K"], case["batch"]
                parts = 2 if prec == "high" else 1
                flops = 8 * M * N_ * K * batch * PASSES[prec]
                moved = 2 * 2 * parts * batch * (M * K + K * N_) + 4 * 2 * batch * M * N_
                bound_ms, bound_by = bound_bf16(flops, moved)
                a16 = torch.randn((batch, M, K), device=device).to(torch.bfloat16)
                b16 = torch.randn((batch, K, N_), device=device).to(torch.bfloat16)

                def matmuls():
                    for _ in range(4 * PASSES[prec]):
                        torch.matmul(a16, b16)
                library_ms = t(matmuls)
                del a16, b16
                rec = dict(name=f"wgmma_{pattern}.{prec}", n=n, M=M, N=N_, K=K, batch=batch,
                           rel_err=err, rel_err_f64=err64, tol=tol, ms=ms, bound_ms=bound_ms,
                           bound_by=bound_by, share=bound_ms / ms, library_ms=library_ms)
                records.append(rec)
                print(f"{what} ({M}x{N_}x{K}, batch {batch}): rel vs emulation {err:.2e}, vs "
                      f"float64 {err64:.2e} (limit {tol:g}); {ms:.5f} ms queued, bound "
                      f"{bound_ms:.5f} ms ({bound_by}), share {rec['share']:.1%}, torch.matmul "
                      f"on bf16 planes {library_ms:.5f} ms", flush=True)
            del case, ref, ref_probs, got, emu
            torch.cuda.empty_cache()
    return records


def run_precision16(device):
    """precision16: runners/bench_precision.py's configurations under each
    setting, the launches counted a setting at a time (kernels 1-2 of the
    setting's precision, kernel 3 and stein_gcorr, no other). Returns (the
    launches summed over the settings, the rows)."""
    import torch
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.ops.kernels import _lib
    from tensornetworks_tpu_torch.runners import bench_precision as bp

    total, rows = {}, []
    for prec, knobs in bp.SETTINGS:
        kernels.reset_launches()
        got = bp.run_setting(prec, knobs, device=device)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        # kernels 1-2 at the setting's precision; the chain's Stein operator
        # (n=16) runs kernel 3 and stein_gcorr, Sprinkler's (n=3) is dense.
        want = {*(_lib.launch_key(k, prec) for k in ("circuit2d_fwd", "circuit2d_bwd")),
                "stein2d", "stein_gcorr"}
        for key, count in launches.items():
            require((count > 0) == (key in want),
                    f"precision16 {prec}/{knobs}: kernel {key} launched {count}x")
            total[key] = total.get(key, 0) + count
        for r in got:
            rows.append(r)
            print(f"precision16 [{prec}/{knobs}] {r['config']}: best TVD {r['best_tvd']:.6f}, "
                  f"loss[-1] {r['final_loss']:.5f}, {r['epochs_per_sec']:.1f} epochs/s "
                  f"({r['seconds']:.1f} s, {r['backend']})", flush=True)
    best = {(r["config"], r["precision"], r["knobs"]): r["best_tvd"] for r in rows}
    for prec in ("highest", "high"):
        tvd = best[("sprinkler3", prec, "both")]
        require(tvd <= SPRINKLER_TVD_MAX, f"precision16 sprinkler3 under {prec}: best TVD {tvd}")
    print(f"precision16: 16q best TVD high {best[('chain16', 'high', 'both')]:.5f} vs highest "
          f"{best[('chain16', 'highest', 'both')]:.5f} (default "
          f"{best[('chain16', 'default', 'both')]:.5f}); Sprinkler high "
          f"{best[('sprinkler3', 'high', 'both')]:.5f} vs highest "
          f"{best[('sprinkler3', 'highest', 'both')]:.5f} (default "
          f"{best[('sprinkler3', 'default', 'both')]:.5f})", flush=True)
    return total, rows


def check_bf16_loops(path, before):
    """The bf16 products of kernels 5-6 that ``path`` launched since the
    counts ``before`` (``circuit2d_grid.bf16_product_counts``): every one on
    the wgmma loop, none on the mma.sync passes. Returns the counts."""
    from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg

    after = kg.bf16_product_counts()
    got = {k: after[k] - before[k] for k in after}
    require(got["wgmma"] > 0 and got["mma_sync"] == 0,
            f"{path}: bf16 products by loop {got}, want all on the wgmma loop")
    return got


@contextlib.contextmanager
def kernel_precision(name):
    """The kernel precision ``name`` for the plans built inside."""
    from tensornetworks_tpu_torch.ops.kernels import precision

    old = precision._kernel_precision()
    precision.set_kernel_precision(name)
    try:
        yield
    finally:
        precision.set_kernel_precision(old)


def run_exact24_high(device, precision_records):
    """exact24 under the kernel precision ``high``: its launches, the loss
    history's largest relative gap to exact24's, epochs/s, and the n=24
    high variants' times from precision_kernels."""
    import torch
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.runners import run_scale_experiment

    from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    before = kg.bf16_product_counts()
    with kernel_precision("high"):
        out = run_scale_experiment(num_qubits=N_EXACT24, layers=BN_LAYERS, ansatz=BN, lr=BN_LR,
                                   num_epochs=EXACT24_EPOCHS, chunk_epochs=EXACT24_CHUNK,
                                   track_tvd=True, seed=0, verbose=False, device=device)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_launches("exact24_high", launches)
    loops = check_bf16_loops("exact24_high", before)
    peak = torch.cuda.max_memory_allocated() / 2**30
    hist, ref = out["history"], REFERENCE_RUNS["exact24"]
    loss = hist["loss_ksd"]
    require(all(math.isfinite(x) for x in loss), "exact24_high loss not finite")
    require(hist["num_skipped_updates"] == 0, "exact24_high skipped updates")
    gap = max(abs(a - b) / abs(b) for a, b in zip(loss, ref["loss_ksd"]))
    require(gap <= EXACT24_HIGH_GAP_MAX,
            f"exact24_high loss history {gap:.3e} from exact24's (limit {EXACT24_HIGH_GAP_MAX})")
    steady = hist.get("epochs_per_sec_steady", hist["epochs_per_sec"])
    k56 = {r["name"]: r["ms"] for r in precision_records
           if r["n"] == N_EXACT24 and r["name"].endswith(".high")}
    row = {"path": "exact24_high", "epochs_per_sec": steady,
           "fp32_epochs_per_sec": ref.get("epochs_per_sec_steady"), "loss_gap": gap,
           "best_tvd": out["model"].best_tvd_, "launches": launches, "kernel_ms": k56,
           "bf16_products": loops, "peak_gib": peak}
    print(f"exact24_high path: {EXACT24_EPOCHS} epochs, loss {loss[0]:.5f} -> {loss[-1]:.5f}, "
          f"largest relative gap to exact24's history {gap:.2e}, {steady:.3f} epochs/s steady "
          f"(exact24 {row['fp32_epochs_per_sec']:.3f}), best TVD {row['best_tvd']:.5f}, "
          f"kernel 5-6 ms {k56}, bf16 products by loop {loops}, peak device memory "
          f"{peak:.2f} GiB, launches {launches}", flush=True)
    return launches, row


def run_grid20_default(device):
    """scale20's configuration under the kernel precision ``default``, 20
    epochs: the path of kernels 5-6's ``default`` variants."""
    import torch
    from tensornetworks_tpu_torch.ops import kernels
    from tensornetworks_tpu_torch.runners import run_scale_experiment

    from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg

    kernels.reset_launches()
    before = kg.bf16_product_counts()
    with kernel_precision("default"):
        out = run_scale_experiment(num_qubits=N_GRID, layers=LAYERS,
                                   num_epochs=GRID20_DEFAULT_EPOCHS,
                                   chunk_epochs=GRID20_DEFAULT_CHUNK, seed=0, verbose=False,
                                   device=device)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_launches("grid20_default", launches)
    loops = check_bf16_loops("grid20_default", before)
    hist = out["history"]
    require(all(math.isfinite(x) for x in hist["loss_ksd"]), "grid20_default loss not finite")
    steady = hist.get("epochs_per_sec_steady", hist["epochs_per_sec"])
    print(f"grid20_default path: {GRID20_DEFAULT_EPOCHS} epochs, loss {hist['loss_ksd'][0]:.5f} "
          f"-> {hist['loss_ksd'][-1]:.5f}, {steady:.2f} epochs/s steady, bf16 products by loop "
          f"{loops}, launches {launches}", flush=True)
    return launches, {"path": "grid20_default", "epochs_per_sec": steady, "launches": launches,
                      "bf16_products": loops}


def run_sampled28_tf32(device):
    """sampled28 on the blocked adjoint executor (asked for: an FP32
    machine takes the gate path) under ``TNTPU_MATMUL_PRECISION=default``:
    its cuBLAS GEMMs in TF32. Its epochs/s and the U-statistics' gap to
    sampled28's (FP32, gate path) history."""
    import torch
    from tensornetworks_tpu_torch.engines import SampledKSDVariationalInference
    from tensornetworks_tpu_torch.ops import kernels

    n = N_SAMPLED28
    bn, latent, obs = sampled_problem(n)
    eng = SampledKSDVariationalInference(bn, latent, list(obs), qbm_ansatz_layers=LAYERS,
                                         num_samples=SHOTS, seed=0, base_kernel_length_scale=1.0,
                                         qbm_grad_method="adjoint", device=device)
    bm = eng.born_machine
    require((bm.backend, bm.grad_method) == ("blocked", "adjoint"),
            f"sampled28_tf32 runs {bm.backend}/{bm.grad_method}, not the blocked adjoint")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    old = os.environ.get("TNTPU_MATMUL_PRECISION")
    os.environ["TNTPU_MATMUL_PRECISION"] = "default"
    try:
        hist = eng.train(obs, num_epochs=SAMPLED28_EPOCHS, lr_born_machine=0.05, verbose=False,
                         chunk_epochs=SAMPLED28_CHUNK)
    finally:
        if old is None:
            os.environ.pop("TNTPU_MATMUL_PRECISION")
        else:
            os.environ["TNTPU_MATMUL_PRECISION"] = old
    torch.cuda.synchronize()
    require(not torch.backends.cuda.matmul.allow_tf32, "sampled28_tf32 left TF32 on")
    launches = dict(kernels.LAUNCHES)
    check_launches("sampled28_tf32", launches)
    loss, ref = hist["loss_ksd"], REFERENCE_RUNS["sampled28"]
    require(all(math.isfinite(x) for x in loss), "sampled28_tf32 U-statistic not finite")
    require(hist["num_skipped_updates"] == 0, "sampled28_tf32 skipped updates")
    gap = max(abs(a - b) for a, b in zip(loss, ref["loss_ksd"])) / max(
        abs(x) for x in ref["loss_ksd"])
    eps = hist.get("epochs_per_sec_steady", hist["epochs_per_sec"])
    ref_eps = ref.get("epochs_per_sec_steady", ref["epochs_per_sec"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"sampled28_tf32 path: {SAMPLED28_EPOCHS} epochs, U-statistic {loss[0]:.4f} -> "
          f"{loss[-1]:.4f} (FP32 {ref['loss_ksd'][0]:.4f} -> {ref['loss_ksd'][-1]:.4f}), largest "
          f"gap {gap:.2e} of the largest FP32 U-statistic, {eps:.3f} epochs/s steady (FP32 "
          f"{ref_eps:.3f}), peak device memory {peak:.2f} GiB", flush=True)
    return launches, {"path": "sampled28_tf32", "epochs_per_sec": eps,
                      "fp32_epochs_per_sec": ref_eps, "ustat_gap": gap, "peak_gib": peak,
                      "launches": launches}


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
    shard_records = [dict(r, path="dist_sampled20x4")
                     for r in check_shard_passes(device) + check_pair_kernels(device)]
    t0 = phase("shard kernel checks", t0)

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
    records += shard_records
    t0 = phase("kernel checks", t0)
    bn_records = check_bn_circuits(device)
    t0 = phase("bn_structured kernel checks", t0)
    wide_records = check_large_n(device)
    t0 = phase("large-n kernel checks", t0)
    path_launches = {}
    path_launches["main16"], eps = run_main_path(device)
    t0 = phase("main16 path", t0)
    path_launches["scale20"], eps20, scale20_hist = run_scale_path(device)
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
    sampled_ops = check_sampling_ops(device)
    t0 = phase("sampled-KSD op checks", t0)
    sampled_line = []
    for path, run in (("sampled16", run_sampled16_path), ("sampled24", run_sampled24_path),
                      ("sampled28", run_sampled28_path), ("sampling20", run_sampling20)):
        path_launches[path], row = run(device)
        sampled_line.append(row)
        t0 = phase(f"{path} path", t0)
        if path == "sampled16":
            run_sampled16_replay(device, REFERENCE_RUNS["sampled16"])
            t0 = phase("sampled16 replay", t0)
    amortized_line = check_conditioned_kernels(device)
    t0 = phase("conditioned kernel checks", t0)
    for path, run in (("amortized16", run_amortized16_path),
                      ("amortized20", run_amortized20_path), ("warm16", run_warm16_path),
                      ("multiseed16", run_multiseed16_path)):
        path_launches[path], row = run(device)
        amortized_line.append(row)
        t0 = phase(f"{path} path", t0)

    cli_line = []
    for path, run in (("cli16", run_cli16_path), ("cli20", run_cli20_path),
                      ("cli_adv16", run_cli_adv16_path), ("profile16", run_profile16_path),
                      ("state16", functools.partial(run_state_path, "state16", N)),
                      ("state20", functools.partial(run_state_path, "state20", N_GRID))):
        path_launches[path], row = run(device)
        cli_line.append(row)
        t0 = phase(f"{path} path", t0)

    torch.cuda.empty_cache()  # the ranks share the card with this process
    dist_line = []
    path_launches["dist20"], row, dist20_hist = run_dist20_path(device, scale20_hist)
    dist_line.append(row)
    t0 = phase("dist20 path", t0)
    path_launches["dist20x4"], row = run_dist20x4_path(device, dist20_hist)
    dist_line.append(row)
    t0 = phase("dist20x4 path", t0)
    launches, rows = run_dist_rank_phases(device)
    path_launches.update(launches)
    dist_line += rows
    t0 = phase("dist_sampled20x4, amortized_mesh16x4 and multiseed_mesh16x4 paths", t0)

    precision_records = check_precision_kernels(device)
    t0 = phase("precision_kernels", t0)
    product_records = check_wgmma_products(device)
    t0 = phase("wgmma_products", t0)
    path_launches["precision16"], precision16_rows = run_precision16(device)
    t0 = phase("precision16", t0)
    precision_line = [{k: r[k] for k in ("name", "n", "ansatz", "layers", "rel_err", "rel_err_f64",
                                         "plain_rel_err_f64", "tol", "ms", "fp32_ms", "plain_ms",
                                         "bound_ms", "bound_by", "share")}
                      for r in precision_records] + product_records + precision16_rows
    for path, run in (("exact24_high", functools.partial(run_exact24_high,
                                                         precision_records=precision_records)),
                      ("grid20_default", run_grid20_default),
                      ("sampled28_tf32", run_sampled28_tf32)):
        path_launches[path], row = run(device)
        precision_line.append(row)
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
    for variant, (path, (n, ansatz)) in VARIANT_PATH.items():
        r = next(r for r in precision_records
                 if (r["name"], r["n"], r["ansatz"]) == (variant, n, ansatz))
        base = variant.split(".")[0]
        require(path_launches[path][variant] > 0, f"{variant} never launched on {path}")
        kernels_line.append({
            "name": variant, "route": "cuda", "source": VARIANT_SOURCES.get(base, SOURCES[base]),
            "replaces": REPLACES[base], "launches": path_launches[path][variant],
            "launches_by_path": {p: c[variant] for p, c in path_launches.items()
                                 if c.get(variant)},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    require(sorted(k["name"] for k in kernels_line) == sorted([*SOURCES, *PRECISION_VARIANTS]),
            "the kernels line does not list every kernel and variant")
    bn_path = {k: path for path in ("bn16", "bn20") for k in PATH_KERNELS[path]}
    bn_line = []
    for r in bn_records:  # the dense FP32 grid kernels: checked at bn20's shape, off its path
        path = bn_path.get(r["name"], "bn20")
        bn_line.append({k: r[k] for k in ("name", "n", "layers", "max_abs_err", "rel_err", "ms",
                                          "plain_ms", "bound_ms", "bound_by", "share")}
                       | {"path": path, "launches": path_launches[path][r["name"]]})
    wide_path = {N: "bn16", N_GRID: "scale20", N_EXACT22: "exact22", N_EXACT24: "exact24",
                 N_SAMPLED28: "sampled28"}
    wide_line = [{k: r[k] for k in ("name", "n", "max_abs_err", "rel_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms", "share")}
                 | {"path": wide_path[r["n"]],
                    "launches": path_launches[wide_path[r["n"]]][r["name"]]}
                 for r in wide_records]
    print(f"main path {eps:.2f} epochs/s, scale20 path {eps20:.2f} epochs/s, bn16 path "
          f"{eps_bn16:.2f} epochs/s, bn20 path {eps_bn20:.2f} epochs/s, "
          + "".join(f"{p} path {e:.2f} epochs/s, " for p, e in new_paths.items())
          + "".join(f"{r['path']} path {r['epochs_per_sec']:.3f} epochs/s, "
                    for r in sampled_line if "epochs_per_sec" in r)
          + f"sampling20 {sampled_line[-1]['samples_per_sec']:,.0f} samples/s, "
          + "".join(f"{r['path']} path {r['epochs_per_sec']:.2f} epochs/s, "
                    for r in amortized_line if "path" in r)
          + "".join(f"{r['path']} path {r['epochs_per_sec']:.2f} epochs/s, "
                    for r in cli_line if "epochs_per_sec" in r)
          + "".join(f"{r['path']} path {r['epochs_per_sec']:.2f} epochs/s, " for r in dist_line)
          + "".join(f"{r['path']} path {r['epochs_per_sec']:.3f} epochs/s, "
                    for r in precision_line if "path" in r)
          + f"on {card}; "
          f"{time.perf_counter() - t_start:.1f}s in all")
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"bn_structured": bn_line}))
    print(json.dumps({"large_n": wide_line}))
    print(json.dumps({"sampled": sampled_line, "checks": sampled_ops}))
    print(json.dumps({"amortized": amortized_line}))
    print(json.dumps({"cli": cli_line}))
    print(json.dumps({"distributed": dist_line}))
    print(json.dumps({"precision": precision_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def cli_adv16_main(device) -> int:
    """The entry of ``chip_smoke.py --cli-adv16 DEVICE``: cli_adv16 alone,
    its launches and row as JSON on the last line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import tensornetworks_tpu_torch  # noqa: F401  (sets FP32 matmul precision)
    from tensornetworks_tpu_torch.ops import kernels

    kernels.build_all()
    launches, row = cli_adv16_in_process(torch.device(device))
    print(json.dumps({"launches": launches, "row": row}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(cli_adv16_main(sys.argv[2]) if sys.argv[1:2] == ["--cli-adv16"] else main())
    except PhaseError as e:
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
