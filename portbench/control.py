"""Readings for the limits of ``correct``, in one process for many seeds.

    python3 -m portbench.control --workload exact_bn8.n24 \\
        --plan program:1-12 control:21-23 altered_q:31-33

Each item of ``--plan`` is a variant and a range of seeds. ``program`` runs
the program as its configuration states; ``control`` runs it with the
overrides of ``controls/<cell>.json`` (the program's own lower-precision
path); ``key=value`` overrides one key of the configuration (such as
``matmul_precision=default``); any other variant is a fault of
``faults.py`` planted in the program (in every rank of a cell on several
chips). Each seed builds the cell, trains the steps that the reference
follows (no measured window: the readings need none), and prints one JSON
line with the numbers that ``correct`` compares.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse_plan(items):
    plan = []
    for item in items:
        variant, _, seeds = item.partition(":")
        lo, _, hi = seeds.partition("-")
        plan += [(variant, s) for s in range(int(lo), int(hi or lo) + 1)]
    return plan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--plan", nargs="+", required=True)
    args = ap.parse_args(argv)

    from portbench.harness import ROOT, find_cell, load_json, run_cell

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    for variant, seed in parse_plan(args.plan):
        spec = find_cell(args.workload)
        faults = ()
        if variant == "control":
            spec.config.update(load_json(ROOT / "controls" / f"{args.workload}.json"))
        elif "=" in variant:
            key, _, value = variant.partition("=")
            spec.config[key] = value
        elif variant != "program":
            faults = (variant,)
        t = time.perf_counter()
        res = run_cell(spec, seed, 0.0, False, t, log=log, faults=faults)
        print(json.dumps({"cell": args.workload, "variant": variant, "seed": seed,
                          "correct": res["correct"], "numbers": res["numbers"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
