"""Where an epoch of the main path spends its time, on the card.

    python -m tensornetworks_tpu_torch.runners.profile_main_path [--epochs 50] [--qubits 16]
        [--ansatz hardware_efficient] [--layers 4]

Trains the main-path workload (random chain network of n+1 variables, seed
0, V{n}=1 observed; hardware_efficient, L=4 by default, or bn_structured
with the network's latent edges; n=16 by default, n=20 for the large-n path
through the grid kernels) once to warm up, then again under
``torch.profiler`` and prints: wall time per epoch, device busy time per
epoch (the sum of kernel times; one stream, so kernels do not overlap), the
device's idle share, the operators with the most device and host time, and
how many of the epoch's aten calls the θ → Mr/Mc Kronecker fold and its
autograd make on their own. The last line is the same summary as JSON.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..core import get_random_chain_network
from ..engines import QuantumKSDVariationalInference
from ..sim.gates import rotation_operators


def profile_main_path(epochs: int = 50, n: int = 16, layers: int = 4, top: int = 12,
                      ansatz: str = "hardware_efficient") -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_main_path measures the card: no CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bn = get_random_chain_network(n + 1, seed=0)
    latent, obs = [f"V{i}" for i in range(n)], {f"V{n}": 1}
    post = bn.posterior_vector(latent, obs)
    eng = QuantumKSDVariationalInference(bn, latent, list(obs), qbm_num_latent_vars=n,
                                         qbm_ansatz_layers=layers, qbm_ansatz_type=ansatz,
                                         seed=0)
    kw = dict(num_epochs=epochs, lr_born_machine=5e-3, verbose=False,
              true_posterior_for_tvd=post)
    eng.train(obs, **kw)  # warm-up: kernel build, allocator, cuBLAS handles
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.train(obs, **kw)
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

    theta = eng.params.detach().clone().requires_grad_(True)
    with profile(activities=[ProfilerActivity.CPU]) as fold_prof:
        planes = [t.contiguous() for M in rotation_operators(theta, n, layers, 3)
                  for t in (M.real, M.imag)]
        torch.autograd.grad(sum(p.sum() for p in planes), theta)
    summary = {
        "device": torch.cuda.get_device_name(0),
        "qubits": n,
        "ansatz": ansatz,
        "layers": layers,
        "backend": eng.born_machine.backend,
        "epochs": epochs,
        "wall_ms_per_epoch": 1e3 * wall / epochs,
        "device_busy_ms_per_epoch": device_us / 1e3 / epochs,
        "device_idle_share": max(0.0, 1.0 - device_us / 1e6 / wall),
        "top_device_us_per_epoch": {e.key[:80]: dev_us(e) / epochs for e in by_device},
        "top_host_us_per_epoch": {e.key[:80]: e.self_cpu_time_total / epochs for e in by_host},
        "host_op_calls_per_epoch": aten_calls(prof) / epochs,
        "fold_fwd_bwd_aten_calls": aten_calls(fold_prof),
    }
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--qubits", type=int, default=16)
    ap.add_argument("--ansatz", default="hardware_efficient")
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args(argv)
    s = profile_main_path(args.epochs, n=args.qubits, layers=args.layers, ansatz=args.ansatz)
    print(f"{s['device']}, {s['qubits']} qubits, {s['ansatz']} L={s['layers']} "
          f"({s['backend']}): "
          f"{s['wall_ms_per_epoch']:.3f} ms/epoch wall, "
          f"{s['device_busy_ms_per_epoch']:.3f} ms/epoch device busy, "
          f"idle share {s['device_idle_share']:.3f}, "
          f"{s['host_op_calls_per_epoch']:.0f} aten calls/epoch, of which the θ fold "
          f"forward+backward makes {s['fold_fwd_bwd_aten_calls']}")
    for title, key in (("device", "top_device_us_per_epoch"), ("host", "top_host_us_per_epoch")):
        print(f"top {title} time, µs per epoch:")
        for name, us in s[key].items():
            print(f"  {us:10.1f}  {name}")
    print(json.dumps(s))


if __name__ == "__main__":
    main()
