#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port on one NVIDIA GPU, the port's mirror
of ``bench.py``.

    python3 bench_torch.py

Three measurements, through the port's engine
(``QuantumKSDVariationalInference.train``) on the 16-qubit workload of
``bench.py`` (random chain network of 17 variables, seed 0, V16=1 observed):

- main16: hardware_efficient L=4, lr 5e-3, 1000 epochs in chunks of 200;
  the steady epochs/s (every chunk after the first, which pays the kernel
  build and warm-up).
- quality path (``bench.py`` ``measure_quality_path``): bn_structured L=8,
  kernel length scale 0.0625, LR-annealed warm restarts (48000 epochs at
  lr 0.05, 24000 at 0.005 and 24000 at 0.001, each restarting the cosine
  schedule from the previous phase's best snapshot), chunks of 1500 epochs,
  the exact TVD tracked every epoch. It reports the best TVD over all
  phases, the steady epochs/s of the first phase, the epochs, the wall
  seconds and the backend.
- vs_baseline: the same cost model of the reference's per-pair Stein kernel
  evaluation as ``bench.py`` (its own copy, torch on the host CPU), times
  the 4^16 pairs of the reference's per-epoch Gram loop; the epochs/s over
  the reference's modelled epochs/s.

Prints each quality phase's result to stderr as it ends, then ONE JSON line
on stdout. Needs a CUDA device: without one it prints one line saying so
and exits 2, so that it never runs on the CPU. Imports nothing of JAX or of
the JAX package.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

N_QUBITS = 16
MAIN_LAYERS, MAIN_EPOCHS, MAIN_CHUNK, MAIN_LR = 4, 1000, 200, 5e-3
QUALITY_LAYERS, QUALITY_LENGTH_SCALE, QUALITY_CHUNK = 8, 0.0625, 1500
QUALITY_PHASES = [(48000, 0.05), (24000, 0.005), (24000, 0.001)]


def measure_reference_pair_seconds(num_vars: int, n_pairs: int = 300) -> float:
    """Time the reference's per-pair Stein kernel cost pattern with torch.

    The computational shape of the reference's ``get_stein_kernel_kp_value``
    (``stein_utils.py:138-197``), as ``bench.py`` models it: per pair,
    ~(5n+1) base-kernel evaluations, each building fresh scalar float64
    tensors, plus the bit-flip tuple churn. A cost model, not a port.
    """
    import torch

    n = num_vars

    def flip(t, i):
        bits = list(t)
        bits[i] = 1 - bits[i]
        return tuple(bits)

    def base_kernel(z1, z2):
        d = torch.sum(torch.abs(z1 - z2))
        return torch.exp(-d / float(n))

    rng = np.random.default_rng(0)
    zs = [tuple(int(b) for b in rng.integers(0, 2, n)) for _ in range(64)]
    sps = [torch.tensor(rng.normal(size=n), dtype=torch.float64) for _ in range(64)]

    t0 = time.perf_counter()
    for p in range(n_pairs):
        z1_t, z2_t = zs[p % 64], zs[(p * 7 + 3) % 64]
        sp1, sp2 = sps[p % 64], sps[(p * 7 + 3) % 64]
        z1 = torch.tensor(z1_t, dtype=torch.float64)
        z2 = torch.tensor(z2_t, dtype=torch.float64)
        k12 = base_kernel(z1, z2)
        term1 = torch.dot(sp1, sp2) * k12
        d2 = torch.zeros(n, dtype=torch.float64)
        for j in range(n):
            d2[j] = k12 - base_kernel(z1, torch.tensor(flip(z2_t, j), dtype=torch.float64))
        term2 = -torch.dot(sp1, d2)
        d1 = torch.zeros(n, dtype=torch.float64)
        for i in range(n):
            d1[i] = k12 - base_kernel(torch.tensor(flip(z1_t, i), dtype=torch.float64), z2)
        term3 = -torch.dot(d1, sp2)
        tr = torch.tensor(0.0, dtype=torch.float64)
        for i in range(n):
            z1n = torch.tensor(flip(z1_t, i), dtype=torch.float64)
            z2n = torch.tensor(flip(z2_t, i), dtype=torch.float64)
            tr = tr + (k12 - base_kernel(z1, z2n) - base_kernel(z1n, z2)
                       + base_kernel(z1n, z2n))
        _ = term1 + term2 + term3 + tr
    return (time.perf_counter() - t0) / n_pairs


def workload():
    from tensornetworks_tpu_torch.runners import make_scale_problem

    bn, latent, obs = make_scale_problem(N_QUBITS, seed=0)
    return bn, latent, obs, bn.posterior_vector(latent, obs)


def measure_main16(device) -> dict:
    """Steady epochs/s of the 16-qubit HE L=4 main path."""
    from tensornetworks_tpu_torch.engines import QuantumKSDVariationalInference

    bn, latent, obs, post = workload()
    eng = QuantumKSDVariationalInference(bn, latent, list(obs), qbm_num_latent_vars=N_QUBITS,
                                         qbm_ansatz_layers=MAIN_LAYERS, seed=0, device=device)
    h = eng.train(obs, num_epochs=MAIN_EPOCHS, lr_born_machine=MAIN_LR, verbose=False,
                  true_posterior_for_tvd=post, chunk_epochs=MAIN_CHUNK)
    return {"epochs_per_sec": h["epochs_per_sec_steady"], "epochs": MAIN_EPOCHS,
            "best_tvd": eng.best_tvd_, "backend": eng.born_machine.backend}


def measure_quality_path(device, phases) -> dict:
    """The bn_structured 16-qubit quality configuration, phase by phase."""
    from tensornetworks_tpu_torch.engines import QuantumKSDVariationalInference

    bn, latent, obs, post = workload()
    eng = QuantumKSDVariationalInference(
        bn, latent, list(obs), qbm_num_latent_vars=N_QUBITS,
        qbm_ansatz_layers=QUALITY_LAYERS, qbm_ansatz_type="bn_structured", seed=0,
        base_kernel_length_scale=QUALITY_LENGTH_SCALE, device=device)
    best_tvd, steady, per_phase = np.inf, None, []
    t0 = time.perf_counter()
    for p_epochs, p_lr in phases:
        h = eng.train(obs, num_epochs=p_epochs, lr_born_machine=p_lr, verbose=False,
                      true_posterior_for_tvd=post, chunk_epochs=QUALITY_CHUNK)
        best_tvd = min(best_tvd, eng.best_tvd_)
        eps = h.get("epochs_per_sec_steady", h["epochs_per_sec"])
        if steady is None:  # throughput from the long first phase
            steady = eps
        per_phase.append({"epochs": p_epochs, "lr": p_lr, "best_tvd": eng.best_tvd_,
                          "best_epoch": eng.best_epoch_, "seconds": h["train_seconds"],
                          "epochs_per_sec": eps, "skipped": h["num_skipped_updates"]})
        print(f"quality phase {per_phase[-1]}", file=sys.stderr, flush=True)
    return {
        "ansatz": "bn_structured",
        "num_qubits": N_QUBITS,
        "layers": QUALITY_LAYERS,
        "edges": len(eng.born_machine.edges),
        "epochs": sum(e for e, _ in phases),
        "lr_phases": [list(p) for p in phases],
        "kernel_length_scale": QUALITY_LENGTH_SCALE,
        "epochs_per_sec": steady,
        "final_tvd": best_tvd,
        "wall_seconds": time.perf_counter() - t0,
        "phases": per_phase,
        "backend": eng.born_machine.backend,
    }


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device; the benchmark runs on the card only")
        return 2
    import tensornetworks_tpu_torch  # noqa: F401  (sets FP32 matmul precision)
    from tensornetworks_tpu_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, file=sys.stderr, flush=True)
    device = torch.device("cuda")
    kernels.build_all()

    main16 = measure_main16(device)
    ref_eps = 1.0 / (measure_reference_pair_seconds(N_QUBITS) * float(4**N_QUBITS))
    quality = measure_quality_path(device, QUALITY_PHASES)
    quality["vs_baseline"] = quality["epochs_per_sec"] / ref_eps
    print(json.dumps({
        "metric": f"quantum_ksd_epochs_per_sec_{N_QUBITS}q",
        "value": main16["epochs_per_sec"],
        "unit": "epochs/sec",
        "vs_baseline": main16["epochs_per_sec"] / ref_eps,
        "path": main16["backend"],
        "main16": main16,
        "quality_path": quality,
        "card": card,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
