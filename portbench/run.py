"""Entry point: run one cell once and print its result line.

    python3 -m portbench.run --workload exact_bn8.n24 --seed 7 --seconds 30 --trace 0

Exits non-zero and prints no result when the cell's CUDA devices are
missing, when JAX or the JAX package was loaded, or on any error. The last
lines of standard error are the numbers ``correct`` compared, each beside
its limit; the last line of standard output is the result as JSON.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import (ChipMissing, ForbiddenImport, find_cell, forbidden_modules,
                                   run_cell)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    spec = find_cell(args.workload)
    try:
        result = run_cell(spec, args.seed, args.seconds, bool(args.trace), T_START, log=log)
    except ChipMissing as e:
        log(f"no run: {e}")
        return 3
    except ForbiddenImport as e:
        log(f"no result: {e}")
        return 4
    found = forbidden_modules()
    if found:
        log(f"no result: modules loaded that the port must not load: {found}")
        return 4
    log("checks (value <= limit):")
    for k, v in result["checks"].items():
        log(f"  {k} {v['value']!r} <= {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
