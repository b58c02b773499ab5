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
  0.05, the TVD on a second forward up to 24 qubits). It also times each
  piece of an epoch at the run's shapes by CUDA events: the loss forward,
  the shots, the scores, the Gram, the backward (forward and backward less
  the forward) and the evaluation forward; and the circuit kernels alone
  and their plain versions on the same planes;
- ``amortized``: amortized KSD-VI (``AmortizedKSD``) of one conditioned
  circuit over the 4 observations of a network of n+2 variables (seed 0,
  V{n} and V{n+1} observed), ``scripts/quality_amortized16.py``'s model:
  bn_structured L=8 re-uploading the wall (``--ansatz``/``--layers`` set
  it), ℓ auto, lr 0.05, clip 10, entropy 0. It also times each piece of an
  epoch, device and host ms: the θ fold, the X wall folds, the X circuit
  forwards, the X Stein applies, and the X backwards (the epoch less the
  rest).
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
from ..core.bits import torch_index_to_bits
from ..core.factors import make_latent_log_joint_fn
from ..engines import (AdversarialVariationalInference, AmortizedKSD, KSDVariationalInference,
                       QuantumKSDVariationalInference, SampledKSDVariationalInference)
from ..models import QuantumBornMachine
from ..ops.stein_sampled import ksd_ustat, reinforce_surrogate, score_at_samples, stein_gram_samples
from ..sim.gates import rotation_operators
from ..sim.sampling import gather_2d, inverse_cdf_sampler
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


def sampled_pieces(eng: SampledKSDVariationalInference, obs: dict) -> dict:
    """Device ms of each piece of a sampled-KSD epoch at the engine's shapes
    (two-stage shots from 20 qubits, as the engine samples)."""
    bm, n, M = eng.born_machine, eng.num_latent_vars, eng.num_samples
    log_joint = make_latent_log_joint_fn(eng.bn, eng.latent_vars_names, obs, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = eng.params.detach().requires_grad_(True)
    rb = (n + 1) // 2
    two_stage = eng.sampling == "two_stage"

    def forward():
        return bm.probs(p).to(torch.float32)

    def shots(q):
        P = q.detach().reshape(1 << rb, -1) if two_stage else q.detach()
        out = inverse_cdf_sampler(P, M, gen)
        return out if two_stage else (out, None, None)

    def loss_and_grad():
        q = forward()
        idx, r, c = shots(q)
        q_at = gather_2d(q.reshape(1 << rb, -1), r, c) if two_stage else q[idx]
        Z = torch_index_to_bits(idx, n)
        gram = stein_gram_samples(score_at_samples(log_joint, Z), Z, n, eng.length_scale)
        loss = ksd_ustat(gram) + reinforce_surrogate(gram, torch.log(q_at.clamp(min=1e-12)))
        return torch.autograd.grad(loss, p)

    pieces = {}
    pieces["loss forward"], q = _device_ms(forward)
    pieces["shots"], (idx, _, _) = _device_ms(lambda: shots(q))
    Z = torch_index_to_bits(idx, n)
    pieces["scores"], S = _device_ms(lambda: score_at_samples(log_joint, Z))
    pieces["gram"], _ = _device_ms(lambda: stein_gram_samples(S, Z, n, eng.length_scale))
    whole, _ = _device_ms(loss_and_grad)
    pieces["backward (epoch less the above)"] = whole - sum(pieces.values())
    with torch.no_grad():
        pieces["eval forward"], _ = _device_ms(forward)
    if bm.backend in ("circuit2d", "circuit2d_grid"):
        pieces.update(circuit_kernel_and_plain_ms(bm, p.detach()))
    return pieces


def circuit_kernel_and_plain_ms(bm, theta) -> dict:
    """Device ms of the Born machine's circuit kernels alone and of their
    plain versions on the same operator planes (θ's), one forward and one
    backward each."""
    from ..ops.kernels import circuit2d as kc
    from ..ops.kernels import circuit2d_grid as kg

    n, L, ansatz = bm.num_latent_vars, bm.ansatz_layers, bm.ansatz_type
    if bm.backend == "circuit2d_grid":
        plan = kg.GridPlan(n, L, ansatz, bm.edges)
        planes = kg.grid_operators(theta, plan)
        fwd, bwd = kg.circuit2d_grid_forward, kg.circuit2d_grid_backward
        fwd_p, bwd_p = kg.circuit2d_grid_forward_plain, kg.circuit2d_grid_backward_plain
    else:
        plan = kc.CircuitPlan(n, L, ansatz, bm.edges)
        Mr, Mc = kc.circuit_operators(theta, plan)
        planes = [t.contiguous() for t in (Mr.real, Mr.imag, Mc.real, Mc.imag)]
        fwd, bwd = kc.circuit2d_forward, kc.circuit2d_backward
        fwd_p, bwd_p = kc.circuit2d_forward_plain, kc.circuit2d_backward_plain
    out = {}
    with torch.no_grad():
        out["kernel forward alone"], (_, xr, xi) = _device_ms(lambda: fwd(*planes, plan))
        out["plain forward alone"], _ = _device_ms(lambda: fwd_p(*planes, plan))
        g = torch.ones_like(xr)
        out["kernel backward alone"], _ = _device_ms(lambda: bwd(*planes, xr, xi, g, plan))
        out["plain backward alone"], _ = _device_ms(lambda: bwd_p(*planes, xr, xi, g, plan))
    return out


def _host_and_device_ms(fn, reps=5):
    """(median device ms by CUDA events, median host ms to issue the calls,
    the last output) of ``fn`` after a warm-up call."""
    out = fn()
    dev, host = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        host.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end))
    return sorted(dev)[reps // 2], sorted(host)[reps // 2], out


def amortized_pieces(eng: AmortizedKSD, observations) -> dict:
    """Device and host ms of each piece of an amortized epoch at the
    engine's shapes: the θ → Mr/Mc fold, the X wall folds, the X circuit
    forwards, the X Stein applies (forward matvecs) and the X backwards
    (the epoch's loss and gradient less the rest)."""
    from ..ops.kernels import circuit2d as kc
    from ..ops.kernels import circuit2d_grid as kg
    from ..sim.gates import fold_wall

    bm = eng.born_machine
    grid = bm.backend == "circuit2d_grid"
    plan = (kg.GridPlan if grid else kc.CircuitPlan)(bm.num_latent_vars, bm.ansatz_layers,
                                                     bm.ansatz_type, bm.edges)
    fn = kg.Circuit2dGridFunction if grid else kc.Circuit2dFunction
    ops = eng.operators(observations)
    X = torch.tensor([eng._x(o) for o in observations], dtype=eng.dtype, device=eng.device)
    p = eng.params.detach().requires_grad_(True)
    circ = p[:bm.num_circuit_params]

    def theta_fold():
        return rotation_operators(circ, plan.n, plan.layers, plan.per_qubit)

    def wall_folds(M):
        out = []
        for x in X:
            Mr, Mc = fold_wall(*M, bm._embed_angles(x, p), plan.n, bm.cond_reupload)
            out.append(kg.grid_planes(Mr, Mc, plan) if grid else
                       [t.contiguous() for t in (Mr.real, Mr.imag, Mc.real, Mc.imag)])
        return out

    def forwards(planes):
        return [fn.apply(*pl, plan).reshape(-1) for pl in planes]

    def stein(qs):
        return [op.ksd_loss(q) for op, q in zip(ops, qs)]

    def epoch():
        q = bm.probs_batch(p, X)
        loss = torch.stack([op.ksd_loss(qx) for op, qx in zip(ops, q)]).mean()
        return torch.autograd.grad(loss, p)

    pieces = {}
    dev, host, M = _host_and_device_ms(theta_fold)
    pieces["theta fold"] = (dev, host)
    dev, host, planes = _host_and_device_ms(lambda: wall_folds(M))
    pieces[f"wall folds (x{len(X)})"] = (dev, host)
    with torch.no_grad():
        dev, host, qs = _host_and_device_ms(lambda: forwards(planes))
        pieces[f"circuit forwards (x{len(X)})"] = (dev, host)
        dev, host, _ = _host_and_device_ms(lambda: stein(qs))
        pieces[f"Stein applies (x{len(X)})"] = (dev, host)
    dev, host, _ = _host_and_device_ms(epoch)
    pieces[f"backwards (x{len(X)}, the epoch less the above)"] = (
        dev - sum(d for d, _ in pieces.values()), host - sum(h for _, h in pieces.values()))
    pieces["whole epoch (loss and gradient)"] = (dev, host)
    return {k: {"device_ms": d, "host_ms": h} for k, (d, h) in pieces.items()}


def _trainer(engine, n, layers, ansatz, epochs, shots=1024):
    """(a function that trains once, the quantum Born machine or None, the
    (engine, observation) of the per-piece timing or None)."""
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
                                  gradient_clip_norm=10.0, entropy_weight=0.0, verbose=False)), \
            qbm, (eng, observations)
    bn = get_random_chain_network(n + 1, seed=0)
    latent, obs = [f"V{i}" for i in range(n)], {f"V{n}": 1}
    post = bn.posterior_vector(latent, obs) if n <= 24 else None
    kw = dict(num_epochs=epochs, verbose=False, true_posterior_for_tvd=post)
    if engine == "classical":
        eng = KSDVariationalInference(bn, latent, list(obs), {"conditioning_dim": 0},
                                      base_kernel_length_scale=1.0, seed=0)
        return lambda: eng.train(obs, lr_born_machine=5e-3, gradient_clip_norm=5.0,
                                 entropy_weight=1e-3, **kw), None, None
    if engine == "adversarial":
        edges = latent_edges(bn, latent) if ansatz == "bn_structured" else None
        qbm = QuantumBornMachine(n, layers, ansatz, edges=edges)
        eng = AdversarialVariationalInference(
            bn, latent, list(obs), born_machine=qbm, seed=0,
            classifier_config={"hidden_dims": [max(2 * n, 32), max(n, 16)]})
        return lambda: eng.train(obs, batch_size=256, lr_born_machine=5e-3,
                                 lr_classifier=5e-2, k_classifier_steps=3,
                                 gradient_clip_norm=5.0, baseline_decay=0.95,
                                 adam_betas=(0.5, 0.999), log_p_floor=60.0, **kw), qbm, None
    if engine == "sampled":
        eng = SampledKSDVariationalInference(bn, latent, list(obs), qbm_ansatz_layers=layers,
                                             qbm_ansatz_type=ansatz, num_samples=shots, seed=0)
        return (lambda: eng.train(obs, lr_born_machine=0.05, **kw)), eng.born_machine, (eng, obs)
    eng = QuantumKSDVariationalInference(bn, latent, list(obs), qbm_num_latent_vars=n,
                                         qbm_ansatz_layers=layers, qbm_ansatz_type=ansatz,
                                         seed=0)
    return lambda: eng.train(obs, lr_born_machine=5e-3, **kw), eng.born_machine, None


def profile_main_path(epochs: int = 50, n: int = 16, layers: int = 4, top: int = 12,
                      ansatz: str = "hardware_efficient", engine: str = "quantum",
                      shots: int = 1024) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_main_path measures the card: no CUDA device")
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    train, qbm, pieces_of = _trainer(engine, n, layers, ansatz, epochs, shots)
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
    if qbm is not None and qbm.backend != "blocked":
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
    if engine == "sampled":
        summary["shots"] = shots
        summary["sampled_pieces_ms"] = sampled_pieces(*pieces_of)
    if engine == "amortized":
        summary["observations"] = len(pieces_of[1])
        summary["amortized_pieces_ms"] = amortized_pieces(*pieces_of)
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
    if "sampled_pieces_ms" in s:
        print(f"pieces of a sampled epoch ({s['shots']} shots), device ms:")
        for name, ms in s["sampled_pieces_ms"].items():
            print(f"  {ms:10.3f}  {name}")
    if "amortized_pieces_ms" in s:
        print(f"pieces of an amortized epoch ({s['observations']} observations), device ms, "
              "host ms:")
        for name, t in s["amortized_pieces_ms"].items():
            print(f"  {t['device_ms']:10.3f} {t['host_ms']:10.3f}  {name}")
    print(json.dumps(s))


if __name__ == "__main__":
    main()
