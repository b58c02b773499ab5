"""Tiny cells for the CPU tests: a copy of ``portbench/`` in a temporary
directory with traffic files of a few latent variables and a
``BENCHMARK.json`` whose cells use the real configurations and the real
cells' limits. ``tiny_dist`` runs the sampled configuration on the
distributed sampled engine over 4 gloo ranks (``sampled_he4_dist``, a
configuration of the copy only)."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1]
# cell: (configuration, real cell, traffic, observed, num_latent, num_vars, chips)
REAL = {"tiny_exact": ("exact_bn8", "exact_bn8.n24", "n24", {"6": 1}, 6, 7, 1),
        "tiny_sampled": ("sampled_he4", "sampled_he4.n24", "n24.obs2", {"6": 1, "7": 0}, 6, 8,
                         1),
        "tiny_dist": ("sampled_he4_dist", "sampled_he4.n24", "n24.obs2", {"8": 1, "9": 0}, 8,
                      10, 4)}


def make_copy(tmp: Path) -> Path:
    """A temporary checkout: ``tmp/portbench`` and ``tmp/BENCHMARK.json``."""
    pb = tmp / "portbench"
    shutil.copytree(SRC, pb, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((SRC.parent / "BENCHMARK.json").read_text())
    cfg = json.loads((SRC / "configs" / "sampled_he4.json").read_text())
    cfg.update(name="sampled_he4_dist", driver="distributed_sampled_ksd")
    (pb / "configs" / "sampled_he4_dist.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "sampled_he4_dist", "source": "CPU test",
                             "file": "portbench/configs/sampled_he4_dist.json", "reduced": [],
                             "why": "CPU test"})
    for cell, (config, real, traffic, observed, n, num_vars, chips) in REAL.items():
        t = json.loads((SRC / "traffic" / f"{traffic}.json").read_text())
        t.update(num_latent=n, num_vars=num_vars, observed=observed, chunk_epochs=4)
        (pb / "traffic" / f"{cell}.json").write_text(json.dumps(t))
        shutil.copy(SRC / "limits" / f"{real}.json", pb / "limits" / f"{cell}.json")
        bench["workloads"].append({"name": cell, "config": config, "traffic": cell,
                                   "chips": chips, "why": "CPU test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return pb


def run(pb: Path, cell: str, seed: int = 2**33 + 7, seconds: float = 0.3, trace=False,
        faults=()):
    """One run of a tiny cell on the CPU with the harness of the copy."""
    sys.path.insert(0, str(pb.parent))
    try:
        for name in [m for m in sys.modules if m == "portbench" or m.startswith("portbench.")]:
            del sys.modules[name]
        import portbench.harness as harness

        spec = harness.find_cell(cell, root=pb)
        return harness.run_cell(spec, seed, seconds, trace, time.perf_counter(), device="cpu",
                                require_chip=False, log=lambda *a: None, faults=faults)
    finally:
        sys.path.remove(str(pb.parent))
        for name in [m for m in sys.modules if m == "portbench" or m.startswith("portbench.")]:
            del sys.modules[name]
