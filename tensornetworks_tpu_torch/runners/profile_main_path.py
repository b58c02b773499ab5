"""Where an epoch of the main path spends its time, on the card.

    python -m tensornetworks_tpu_torch.runners.profile_main_path [--epochs 50] [--qubits 16]
        [--ansatz hardware_efficient] [--layers 4] [--engine quantum]

Trains a workload on the random chain network of n+1 variables (seed 0,
V{n}=1 observed; n=16 by default, n=20 for the large-n path through the
grid kernels) once to warm up, then again under ``torch.profiler``. The
engine is one of
- ``quantum``: exact quantum KSD-VI, hardware_efficient L=4 by default or
  bn_structured with the network's latent edges (the main path);
- ``classical``: exact KSD-VI of a 2^n softmax table
  (``KSDVariationalInference``; ℓ = 1, lr 5e-3, clip 5, entropy 1e-3);
- ``adversarial``: adversarial VI of the quantum Born machine
  (``AdversarialVariationalInference`` with the scale runner's settings:
  batch 256, 3 discriminator steps, lr 5e-3 and 5e-2, the log p floor).
It prints: wall time per epoch, device busy time per epoch (the sum of
kernel times; one stream, so kernels do not overlap), the device's idle
share, the peak device memory of the profiled run (operator build
included), the operators with the most device and host time, and, for the
quantum engines, how many of the epoch's aten calls the θ → Mr/Mc
Kronecker fold and its autograd make on their own. The last line is the
same summary as JSON. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..core import get_random_chain_network
from ..engines import (AdversarialVariationalInference, KSDVariationalInference,
                       QuantumKSDVariationalInference)
from ..models import QuantumBornMachine
from ..sim.gates import rotation_operators
from ..sim.structured import latent_edges

ENGINES = ("quantum", "classical", "adversarial")


def _trainer(engine, n, layers, ansatz, epochs):
    """(a function that trains once, the quantum Born machine or None)."""
    bn = get_random_chain_network(n + 1, seed=0)
    latent, obs = [f"V{i}" for i in range(n)], {f"V{n}": 1}
    post = bn.posterior_vector(latent, obs)
    kw = dict(num_epochs=epochs, verbose=False, true_posterior_for_tvd=post)
    if engine == "classical":
        eng = KSDVariationalInference(bn, latent, list(obs), {"conditioning_dim": 0},
                                      base_kernel_length_scale=1.0, seed=0)
        return lambda: eng.train(obs, lr_born_machine=5e-3, gradient_clip_norm=5.0,
                                 entropy_weight=1e-3, **kw), None
    if engine == "adversarial":
        edges = latent_edges(bn, latent) if ansatz == "bn_structured" else None
        qbm = QuantumBornMachine(n, layers, ansatz, edges=edges)
        eng = AdversarialVariationalInference(
            bn, latent, list(obs), born_machine=qbm, seed=0,
            classifier_config={"hidden_dims": [max(2 * n, 32), max(n, 16)]})
        return lambda: eng.train(obs, batch_size=256, lr_born_machine=5e-3,
                                 lr_classifier=5e-2, k_classifier_steps=3,
                                 gradient_clip_norm=5.0, baseline_decay=0.95,
                                 adam_betas=(0.5, 0.999), log_p_floor=60.0, **kw), qbm
    eng = QuantumKSDVariationalInference(bn, latent, list(obs), qbm_num_latent_vars=n,
                                         qbm_ansatz_layers=layers, qbm_ansatz_type=ansatz,
                                         seed=0)
    return lambda: eng.train(obs, lr_born_machine=5e-3, **kw), eng.born_machine


def profile_main_path(epochs: int = 50, n: int = 16, layers: int = 4, top: int = 12,
                      ansatz: str = "hardware_efficient", engine: str = "quantum") -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_main_path measures the card: no CUDA device")
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    train, qbm = _trainer(engine, n, layers, ansatz, epochs)
    train()  # warm-up: kernel build, allocator, cuBLAS handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return e.self_device_time_total

    device_us = sum(dev_us(e) for e in kernels)
    if not device_us:  # kernels not listed on their own: take the ops' device time
        device_us = sum(dev_us(e) for e in events)
    by_device = sorted(kernels, key=dev_us, reverse=True)[:top]
    by_host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                     key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    def aten_calls(prof_):
        return sum(e.count for e in prof_.key_averages() if e.key.startswith("aten::"))

    fold_calls = None
    if qbm is not None:
        theta = qbm.init(torch.Generator().manual_seed(0)).requires_grad_(True)
        with profile(activities=[ProfilerActivity.CPU]) as fold_prof:
            planes = [t.contiguous() for M in rotation_operators(theta, n, layers, 3)
                      for t in (M.real, M.imag)]
            torch.autograd.grad(sum(p.sum() for p in planes), theta)
        fold_calls = aten_calls(fold_prof)
    summary = {
        "device": torch.cuda.get_device_name(0),
        "engine": engine,
        "qubits": n,
        "ansatz": ansatz if qbm is not None else "table",
        "layers": layers if qbm is not None else None,
        "backend": qbm.backend if qbm is not None else "stein only",
        "epochs": epochs,
        "wall_ms_per_epoch": 1e3 * wall / epochs,
        "device_busy_ms_per_epoch": device_us / 1e3 / epochs,
        "device_idle_share": max(0.0, 1.0 - device_us / 1e6 / wall),
        "top_device_us_per_epoch": {e.key[:80]: dev_us(e) / epochs for e in by_device},
        "top_host_us_per_epoch": {e.key[:80]: e.self_cpu_time_total / epochs for e in by_host},
        "host_op_calls_per_epoch": aten_calls(prof) / epochs,
        "fold_fwd_bwd_aten_calls": fold_calls,
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--qubits", type=int, default=16)
    ap.add_argument("--ansatz", default="hardware_efficient")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--engine", choices=ENGINES, default="quantum")
    args = ap.parse_args(argv)
    s = profile_main_path(args.epochs, n=args.qubits, layers=args.layers, ansatz=args.ansatz,
                          engine=args.engine)
    fold = ("" if s["fold_fwd_bwd_aten_calls"] is None else
            f", of which the θ fold forward+backward makes {s['fold_fwd_bwd_aten_calls']}")
    print(f"{s['device']}, {s['engine']} engine, {s['qubits']} qubits, {s['ansatz']} "
          f"L={s['layers']} ({s['backend']}): "
          f"{s['wall_ms_per_epoch']:.3f} ms/epoch wall, "
          f"{s['device_busy_ms_per_epoch']:.3f} ms/epoch device busy, "
          f"idle share {s['device_idle_share']:.3f}, "
          f"peak device memory {s['peak_device_gib']:.2f} GiB, "
          f"{s['host_op_calls_per_epoch']:.0f} aten calls/epoch{fold}")
    for title, key in (("device", "top_device_us_per_epoch"), ("host", "top_host_us_per_epoch")):
        print(f"top {title} time, µs per epoch:")
        for name, us in s[key].items():
            print(f"  {us:10.1f}  {name}")
    print(json.dumps(s))


if __name__ == "__main__":
    main()
