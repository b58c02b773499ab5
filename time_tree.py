#!/usr/bin/env python3
"""Times the kernels of a checkout of this repo with this checkout's timers,
so that two commits are compared by one timer.

    python3 time_tree.py [--tree DIR]                  # the timed kernels, three timers
    python3 time_tree.py [--tree DIR] --path main16    # a path's epochs/s (main16, scale20, bn20)
    python3 time_tree.py [--tree DIR] --stein-memory 20  # the Stein operator's device bytes

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
``{"path": ..., "epochs_per_s": x}``. With ``--stein-memory N`` it builds
DIR's ``SteinOperator`` for the N-qubit workload at the ``auto`` length
scale and prints the device bytes the operator holds and the peak device
bytes of one matvec above them. Run each tree in its own process, in
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
PATHS = {"main16": "run_main_path", "scale20": "run_scale_path", "bn20": "run_bn20_path"}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(HERE), help="root of the checkout to time")
    ap.add_argument("--path", choices=tuple(PATHS),
                    help="time this path's epochs/s, not the kernels")
    ap.add_argument("--stein-memory", type=int, metavar="N",
                    help="measure the N-qubit Stein operator's device memory")
    args = ap.parse_args(argv)

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
    if args.stein_memory:
        print(json.dumps({"tree": str(tree), **stein_memory(smoke, args.stein_memory, device)}),
              flush=True)
        return 0
    if args.path:
        _, eps = getattr(smoke, PATHS[args.path])(device)
        print(json.dumps({"tree": str(tree), "path": args.path, "epochs_per_s": eps}),
              flush=True)
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
