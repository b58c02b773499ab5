"""Where an epoch of the main path spends its time, on the card.

    python -m tensornetworks_tpu_torch.runners.profile_main_path [--epochs 50] [--qubits 16]
        [--ansatz hardware_efficient] [--layers 4] [--engine quantum] [--shots 1024]
    python -m tensornetworks_tpu_torch.runners.profile_main_path --engine amortized

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
  batch 256, 3 discriminator steps, lr 5e-3 and 5e-2, the log p floor);
- ``sampled``: sampled KSD-VI of the quantum Born machine
  (``SampledKSDVariationalInference``, ``--shots`` per epoch, ℓ = 1, lr
  0.05, the TVD on a second forward up to 24 qubits). It also times the
  circuit kernels alone and their plain versions on the same planes by
  CUDA events (past 24 qubits the kernels alone);
- ``amortized``: amortized KSD-VI (``AmortizedKSD``) of one conditioned
  circuit over the 4 observations of a network of n+2 variables (seed 0,
  V{n} and V{n+1} observed), ``scripts/quality_amortized16.py``'s model:
  bn_structured L=8 re-uploading the wall (``--ansatz``/``--layers`` set
  it), ℓ auto, lr 0.05, clip 10, entropy 0.
It prints: wall time per epoch, device busy time per epoch (the sum of
kernel times; one stream, so kernels do not overlap), the device's idle
share, the peak device memory of the profiled run (operator build
included), the operators with the most device and host time, the pieces
of the epoch as the program's own spans (``train.span``) in the profiled
run: calls, host ms, device ms and kernel launches per epoch of each span,
nested spans included, the backward's kernels (autograd's thread) in
``engine.backward`` (``span_table``), and, for the quantum engines, how
many of the epoch's aten calls the θ → Mr/Mc Kronecker fold and its
autograd make on their own (to 24 qubits, the dense planes' range). The
last line is the same summary as JSON. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import tempfile
import time

import torch

from ..core import get_random_chain_network
from ..engines import (AdversarialVariationalInference, AmortizedKSD, KSDVariationalInference,
                       QuantumKSDVariationalInference, SampledKSDVariationalInference)
from ..models import QuantumBornMachine
from ..ops.kernels.circuit2d_grid import MAX_QUBITS
from ..sim.gates import rotation_operators
from ..sim.structured import latent_edges

ENGINES = ("quantum", "classical", "adversarial", "sampled", "amortized")


def _device_ms(fn, reps=5):
    """Median device ms of ``fn`` over ``reps`` calls by CUDA events, after
    a warm-up call; returns (ms, the last output)."""
    out = fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2], out


def circuit_kernel_and_plain_ms(bm, theta) -> dict:
    """Device ms of the Born machine's circuit kernels alone and of their
    plain versions on the same operator planes or gates (θ's), one forward
    and one backward each; past the dense path's 24 qubits the kernels
    alone (the plain versions' index tables take tens of GiB there)."""
    from ..ops.kernels import circuit2d as kc
    from ..ops.kernels import circuit2d_grid as kg
    from ..sim.gates import layer_rotations

    n, L, ansatz = bm.num_latent_vars, bm.ansatz_layers, bm.ansatz_type
    plan = kg.GridPlan(n, L, ansatz, bm.edges) if bm.backend == "circuit2d_grid" else None
    if plan is not None and plan.precision == "highest":
        planes = [layer_rotations(theta, n, L, plan.per_qubit)]
        fwd, bwd = kg.circuit_gates_forward, kg.circuit_gates_backward
        fwd_p, bwd_p = kg.circuit_gates_forward_plain, kg.circuit_gates_backward_plain
    elif plan is not None:
        planes = kg.grid_operators(theta, plan)
        fwd, bwd = kg.circuit2d_grid_forward, kg.circuit2d_grid_backward
        fwd_p, bwd_p = kg.circuit2d_grid_forward_plain, kg.circuit2d_grid_backward_plain
    else:
        plan = kc.CircuitPlan(n, L, ansatz, bm.edges)
        Mr, Mc = kc.circuit_operators(theta, plan)
        planes = [t.contiguous() for t in (Mr.real, Mr.imag, Mc.real, Mc.imag)]
        fwd, bwd = kc.circuit2d_forward, kc.circuit2d_backward
        fwd_p, bwd_p = kc.circuit2d_forward_plain, kc.circuit2d_backward_plain
    plain = n <= kg.MAX_QUBITS
    out = {}
    with torch.no_grad():
        out["kernel forward alone"], (_, xr, xi) = _device_ms(lambda: fwd(*planes, plan))
        if plain:
            out["plain forward alone"], _ = _device_ms(lambda: fwd_p(*planes, plan))
        g = torch.ones_like(xr)
        out["kernel backward alone"], _ = _device_ms(lambda: bwd(*planes, xr, xi, g, plan))
        if plain:
            out["plain backward alone"], _ = _device_ms(lambda: bwd_p(*planes, xr, xi, g, plan))
    return out


def span_table(trace: dict) -> dict:
    """{span: calls, host ms, device ms, kernel launches} of the program's
    spans (``train.span``) in a profile's chrome trace: host ms are the
    spans' durations, waits for the device included; each span's device
    time and launches include those of the spans nested in it. A device
    operation counts in the innermost span open on the thread that
    launched it; where that thread has none open, as for the backward's
    operators on autograd's thread, in the main thread's innermost span at
    the launch. A span on another thread nests in the main thread's
    innermost span at its start, so ``engine.backward`` and ``engine.epoch``
    hold the backward's kernels, ``circuit.backward``'s among them."""
    spans, launch = {}, {}
    for e in trace.get("traceEvents", ()):
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        thread, ts = (e.get("pid"), e.get("tid")), float(e["ts"])
        if e.get("cat") == "user_annotation":
            spans.setdefault(thread, []).append((ts, ts + float(e.get("dur", 0)), e["name"]))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver"):
            launch[e.get("args", {}).get("correlation")] = (thread, ts)
    if not spans:
        return {}
    main = min(spans, key=lambda k: min(ts for ts, _, _ in spans[k]))
    parents = {}
    for thread, items in spans.items():
        items.sort(key=lambda x: (x[0], -x[1]))
        parent, stack = [], []
        for i, (ts, _, _) in enumerate(items):
            while stack and items[stack[-1]][1] <= ts:
                stack.pop()
            parent.append(stack[-1] if stack else -1)
            stack.append(i)
        parents[thread] = parent

    def innermost(thread, t):
        items = spans.get(thread, ())
        i = bisect.bisect_right(items, (t, float("inf"))) - 1
        while i >= 0 and items[i][1] <= t:
            i = parents[thread][i]
        return (thread, i) if i >= 0 else None

    def around(thread, t):
        """The names of the spans around a launch at t, innermost first."""
        names, at = [], innermost(thread, t) or innermost(main, t)
        while at is not None:
            thread, i = at
            ts, _, name = spans[thread][i]
            if name not in names:
                names.append(name)
            p = parents[thread][i]
            at = (thread, p) if p >= 0 else None if thread == main else innermost(main, ts)
        return names

    table = {}

    def row(name):
        return table.setdefault(name, {"calls": 0, "host_ms": 0.0, "device_ms": 0.0,
                                       "launches": 0})

    for items in spans.values():
        for ts, end, name in items:
            row(name)["calls"] += 1
            row(name)["host_ms"] += (end - ts) / 1e3
    for e in trace["traceEvents"]:
        if isinstance(e, dict) and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            at = launch.get(e.get("args", {}).get("correlation"))
            for name in around(*at) if at else ():
                row(name)["device_ms"] += float(e.get("dur", 0)) / 1e3
                row(name)["launches"] += e["cat"] == "kernel"
    return dict(sorted(table.items(), key=lambda kv: kv[1]["device_ms"], reverse=True))


def _trainer(engine, n, layers, ansatz, epochs, shots=1024):
    """(a function that trains once, the quantum Born machine or None)."""
    if engine == "amortized":
        from itertools import product

        bn = get_random_chain_network(n + 2, seed=0)
        latent, observed = [f"V{i}" for i in range(n)], [f"V{n}", f"V{n + 1}"]
        observations = [dict(zip(observed, b)) for b in product((0, 1), repeat=2)]
        edges = latent_edges(bn, latent) if ansatz == "bn_structured" else None
        qbm = QuantumBornMachine(n, layers, ansatz, edges=edges, conditioning_dim=2,
                                 cond_reupload=ansatz == "bn_structured")
        eng = AmortizedKSD(bn, latent, observed, born_machine=qbm, seed=0,
                           base_kernel_length_scale="auto")
        return (lambda: eng.train(observations, num_epochs=epochs, lr=0.05,
                                  gradient_clip_norm=10.0, entropy_weight=0.0,
                                  verbose=False)), qbm
    bn = get_random_chain_network(n + 1, seed=0)
    latent, obs = [f"V{i}" for i in range(n)], {f"V{n}": 1}
    post = bn.posterior_vector(latent, obs) if n <= 24 else None
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
    if engine == "sampled":
        eng = SampledKSDVariationalInference(bn, latent, list(obs), qbm_ansatz_layers=layers,
                                             qbm_ansatz_type=ansatz, num_samples=shots, seed=0)
        return (lambda: eng.train(obs, lr_born_machine=0.05, **kw)), eng.born_machine
    eng = QuantumKSDVariationalInference(bn, latent, list(obs), qbm_num_latent_vars=n,
                                         qbm_ansatz_layers=layers, qbm_ansatz_type=ansatz,
                                         seed=0)
    return lambda: eng.train(obs, lr_born_machine=5e-3, **kw), eng.born_machine


def profile_main_path(epochs: int = 50, n: int = 16, layers: int = 4, top: int = 12,
                      ansatz: str = "hardware_efficient", engine: str = "quantum",
                      shots: int = 1024) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_main_path measures the card: no CUDA device")
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    train, qbm = _trainer(engine, n, layers, ansatz, epochs, shots)
    train()  # warm-up: kernel build, allocator, cuBLAS handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            spans = span_table(json.load(f))
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]  # the spans' device copies

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

    fold_calls = None  # the dense fold's planes exist to 24 qubits
    if qbm is not None and qbm.backend != "blocked" and n <= MAX_QUBITS:
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
        "spans_per_epoch": {name: {k: v / epochs for k, v in row.items()}
                            for name, row in spans.items()},
        "fold_fwd_bwd_aten_calls": fold_calls,
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    if engine == "sampled" and qbm.backend in ("circuit2d", "circuit2d_grid"):
        summary["circuit_kernel_and_plain_ms"] = circuit_kernel_and_plain_ms(
            qbm, qbm.init(torch.Generator().manual_seed(0)))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--qubits", type=int, default=16)
    ap.add_argument("--ansatz", default=None,
                    help="hardware_efficient (bn_structured for --engine amortized)")
    ap.add_argument("--layers", type=int, default=None, help="4 (8 for --engine amortized)")
    ap.add_argument("--engine", choices=ENGINES, default="quantum")
    ap.add_argument("--shots", type=int, default=1024, help="sampled engine: shots per epoch")
    args = ap.parse_args(argv)
    amortized = args.engine == "amortized"
    if args.ansatz is None:
        args.ansatz = "bn_structured" if amortized else "hardware_efficient"
    if args.layers is None:
        args.layers = 8 if amortized else 4
    s = profile_main_path(args.epochs, n=args.qubits, layers=args.layers, ansatz=args.ansatz,
                          engine=args.engine, shots=args.shots)
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
    print("spans per epoch: calls, host ms, device ms, kernel launches (nested spans included):")
    for name, row in s["spans_per_epoch"].items():
        print(f"  {row['calls']:8.2f} {row['host_ms']:10.3f} {row['device_ms']:10.3f} "
              f"{row['launches']:8.2f}  {name}")
    if "circuit_kernel_and_plain_ms" in s:
        print("circuit kernels alone and their plain versions, device ms:")
        for name, ms in s["circuit_kernel_and_plain_ms"].items():
            print(f"  {ms:10.3f}  {name}")
    print(json.dumps(s))


if __name__ == "__main__":
    main()
