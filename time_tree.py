#!/usr/bin/env python3
"""Times the kernels of a checkout of this repo with this checkout's timers,
so that two commits are compared by one timer.

    python3 time_tree.py [--tree DIR]                  # the timed kernels, three timers
    python3 time_tree.py [--tree DIR] --path main16    # a path's epochs/s (PATHS; a,b: several)
    python3 time_tree.py [--tree DIR] --stein-memory 20  # the Stein operator's device bytes
    python3 time_tree.py [--tree DIR] --digest         # SHA-256 of the circuit kernels' outputs
    python3 time_tree.py [--tree DIR] --precision16    # kernels 1-2's bf16 variants at n=16

DIR is the root of a checkout (by default this one), for example an earlier
commit unpacked with ``git archive`` into a git-ignored directory. The script
loads DIR's ``chip_smoke.py`` and its package, builds DIR's kernels, and runs
that ``chip_smoke.py``'s four timed checks (circuit2d and stein2d at n=16,
circuit2d_grid and stein2d_grid at n=20) once under each timer, in place of
its own ``time_ms``:

- ``unqueued``: CUDA events around 20 calls, median of 5 rounds
  (``chip_smoke.time_ms(queued=False)``); a call faster than its host cost
  reads as that cost;
- ``queued``: the same behind a device sleep (``chip_smoke.time_ms``, the
  timer of the ``kernels`` line);
- ``profiler``: the device time of the kernels of 20 calls by
  ``torch.profiler`` (CUPTI), summed and divided by 20.

Prints one JSON line per timer: ``{"timer": ..., "kernels": {name: {"ms",
"plain_ms", "library_ms"}}}``. With ``--path main16`` it runs DIR's
``chip_smoke.run_main_path`` instead (300 epochs), with ``--path scale20``
its ``run_scale_path`` (60 epochs at 20 qubits), with ``--path bn20`` its
``run_bn20_path`` (30 epochs, bn_structured L=8), and prints
``{"path": ..., "epochs_per_s": x}``; ``sprinkler_classical``,
``classical20``, ``warm16``, ``multiseed16``, ``cli16``, ``cli20``,
``profile16``, ``sampled16``, ``sampled24`` and ``grid20_default`` run
those phases of DIR's ``chip_smoke.py`` (``sampled16`` also prints its best
TVD), ``sampling20`` its sampling throughput phase (printing
``samples_per_s`` in place of ``epochs_per_s``), and a
comma-separated list runs several paths in
one process, in turn. With ``--stein-memory N`` it builds
DIR's ``SteinOperator`` for the N-qubit workload at the ``auto`` length
scale and prints the device bytes the operator holds and the peak device
bytes of one matvec above them. With ``--digest`` it runs DIR's circuit
kernels (forward and backward, at DIR's default precision) on seeded inputs
at ``DIGEST_SHAPES`` and prints a SHA-256 of their outputs per shape: two
trees with equal digests compute those kernels bit for bit alike. With
``--precision16`` it runs DIR's ``check_precision_case`` (step 16 of its
``chip_smoke.py``) at main16's and bn16's shapes (HE L=4, bn_structured
L=8) under this checkout's queued timer, and prints the bf16 variants of
kernels 1-2 with their errors and queued ms, one JSON line. Run each tree in its own process, in
alternating order, since the host's speed drifts within one machine.
Needs a CUDA device; imports nothing of JAX.
"""

import argparse
import functools
import importlib.util
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPS = 20
PATHS = {"main16": "run_main_path", "scale20": "run_scale_path", "bn20": "run_bn20_path",
         "sprinkler_classical": "run_sprinkler_classical", "classical20": "run_classical20_path",
         "warm16": "run_warm16_path", "multiseed16": "run_multiseed16_path",
         "cli16": "run_cli16_path", "cli20": "run_cli20_path", "profile16": "run_profile16_path",
         "sampled16": "run_sampled16_path", "sampled24": "run_sampled24_path",
         "grid20_default": "run_grid20_default", "sampling20": "run_sampling20"}
# (n, grid, ansatz, layers) of --digest: both persistent kernels at 16 and 17
# qubits, both GEMM loops of the grid kernels at 18-21, bn_structured at 16
# and 20.
DIGEST_SHAPES = ((16, False, "hardware_efficient", 4), (17, False, "hardware_efficient", 4),
                 (16, False, "bn_structured", 8), (18, True, "hardware_efficient", 4),
                 (20, True, "hardware_efficient", 4), (21, True, "hardware_efficient", 4),
                 (20, True, "bn_structured", 8))


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profiler_ms(fn, reps=REPS):
    """Device time per call of ``fn`` by torch.profiler: the summed device
    time of the kernels (and copies) that ``reps`` calls launch, over reps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    us = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA)
    if not us:  # kernels not listed on their own: take the ops' device time
        us = sum(e.self_device_time_total for e in events)
    return us / 1e3 / reps if us > 0 else None


def stein_memory(smoke, n, device) -> dict:
    """Device bytes held by the n-qubit workload's Stein operator (the
    tree's own), and the peak above them during one matvec."""
    import torch
    from tensornetworks_tpu_torch.ops import stein
    from tensornetworks_tpu_torch.ops.hamming import resolve_length_scale

    bn, latent, obs = smoke.path_inputs(n)
    score = stein.score_table(bn.conditional_joint_table(latent, obs))
    q = torch.full((2**n,), 2.0**-n, device=device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    op = stein.SteinOperator(score, n, resolve_length_scale("auto", n), device=device)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    op.matvec(q)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base - held
    return {"stein_memory_qubits": n, "operator_bytes": held, "matvec_peak_bytes": peak}


def digest(device) -> dict:
    """SHA-256 of the tree's circuit kernels' outputs (probs, state planes,
    the four operator gradients) at each of DIGEST_SHAPES, on inputs drawn
    from seeded generators."""
    import hashlib

    import torch
    from tensornetworks_tpu_torch.ops.kernels import circuit2d as kc
    from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg
    from tensornetworks_tpu_torch.runners import make_scale_problem
    from tensornetworks_tpu_torch.sim import latent_edges
    from tensornetworks_tpu_torch.sim.ansatz import num_ansatz_params
    from tensornetworks_tpu_torch.sim.gates import rotation_operators

    out = {}
    for n, grid, ansatz, layers in DIGEST_SHAPES:
        edges = None
        if ansatz == "bn_structured":
            edges = latent_edges(*make_scale_problem(n, seed=0)[:2])
        plan = (kg.GridPlan if grid else kc.CircuitPlan)(n, layers, ansatz, edges)
        gen = torch.Generator().manual_seed(n)
        theta = (0.1 * torch.randn(num_ansatz_params(n, layers, ansatz), generator=gen)).to(device)
        Mr, Mc = rotation_operators(theta, n, layers, plan.per_qubit)
        planes = (kg.grid_planes(Mr, Mc, plan) if grid
                  else [t.contiguous() for t in (Mr.real, Mr.imag, Mc.real, Mc.imag)])
        fwd, bwd = ((kg.circuit2d_grid_forward, kg.circuit2d_grid_backward) if grid
                    else (kc.circuit2d_forward, kc.circuit2d_backward))
        probs, xr, xi = fwd(*planes, plan)
        g = torch.randn((plan.R, plan.C), generator=gen).to(device)
        h = hashlib.sha256()
        for t in (probs, xr, xi, *bwd(*planes, xr, xi, g, plan)):
            h.update(t.cpu().numpy().tobytes())
        out[f"{'circuit2d_grid' if grid else 'circuit2d'} n={n} {ansatz} L={layers}"] = \
            h.hexdigest()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(HERE), help="root of the checkout to time")
    ap.add_argument("--path", type=lambda v: v.split(","),
                    help=f"time these paths' epochs/s, not the kernels (comma-separated: "
                         f"{', '.join(PATHS)})")
    ap.add_argument("--stein-memory", type=int, metavar="N",
                    help="measure the N-qubit Stein operator's device memory")
    ap.add_argument("--digest", action="store_true",
                    help="print a SHA-256 of the circuit kernels' outputs per shape")
    ap.add_argument("--precision16", action="store_true",
                    help="time kernels 1-2's bf16 variants at main16's and bn16's shapes")
    args = ap.parse_args(argv)
    for name in args.path or ():
        if name not in PATHS:
            ap.error(f"unknown path {name!r}; choose from {', '.join(PATHS)}")

    timer_smoke = _load(HERE / "chip_smoke.py", "_timer_smoke")
    tree = Path(args.tree).resolve()
    os.chdir(tree)
    sys.path.insert(0, str(tree))
    smoke = _load(tree / "chip_smoke.py", "chip_smoke")

    import torch

    if not torch.cuda.is_available():
        print("time_tree: no CUDA device", file=sys.stderr)
        return 2
    import tensornetworks_tpu_torch  # noqa: F401  (sets FP32 matmul precision)
    from tensornetworks_tpu_torch.ops import kernels

    device = torch.device("cuda")
    kernels.build_all()
    if args.digest:
        print(json.dumps({"tree": str(tree), "digest": digest(device)}), flush=True)
        return 0
    if args.precision16:
        smoke.time_ms = timer_smoke.time_ms
        rows = []
        for layers, ansatz in ((smoke.LAYERS, smoke.ANSATZ), (smoke.BN_LAYERS, smoke.BN)):
            rows += [{k: r[k] for k in ("name", "ansatz", "layers", "ms", "fp32_ms", "rel_err",
                                        "rel_err_f64", "bound_ms")}
                     for r in smoke.check_precision_case(device, smoke.N, False, ansatz, layers,
                                                         timed=True)]
        print(json.dumps({"tree": str(tree), "precision16": rows}), flush=True)
        return 0
    if args.stein_memory:
        print(json.dumps({"tree": str(tree), **stein_memory(smoke, args.stein_memory, device)}),
              flush=True)
        return 0
    if args.path:
        for name in args.path:
            rate = getattr(smoke, PATHS[name])(device)[1]
            if name == "sampling20":
                got = {"samples_per_s": rate["samples_per_sec"]}
            else:
                got = {"epochs_per_s": rate["epochs_per_sec"] if isinstance(rate, dict) else rate}
            if name == "sampled16":
                got["best_tvd"] = rate["best_tvd"]
            print(json.dumps({"tree": str(tree), "path": name, **got}), flush=True)
        return 0
    timers = {"unqueued": functools.partial(timer_smoke.time_ms, queued=False),
              "queued": timer_smoke.time_ms,
              "profiler": profiler_ms}
    for name, timer in timers.items():
        smoke.time_ms = timer
        records = (smoke.check_circuit(smoke.N, device, timing=True)
                   + smoke.check_stein2d(smoke.N, device)
                   + smoke.check_circuit(smoke.N_GRID, device, timing=True, grid=True)
                   + smoke.check_stein2d(smoke.N_GRID, device))
        print(json.dumps({"tree": str(tree), "timer": name, "kernels": {
            r["name"]: {k: r[k] for k in ("ms", "plain_ms", "library_ms")} for r in records}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
