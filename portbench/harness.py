"""Run one cell of ``BENCHMARK.json`` once.

Everything particular to a cell is a file the harness finds by name:

- ``BENCHMARK.json`` (repo root): the cell's configuration, traffic and
  metrics, with their units;
- ``configs/<config>.json``: the engine's driver and kind, the circuit,
  the optimizer's rate and clip, and the precision the program runs at;
- ``traffic/<traffic>.json``: the problem's shape (``problem.py`` draws its
  numbers from the seed);
- ``drivers/<driver>.py``: the calls into the program's engine, and the
  faults its path can have;
- ``reference/<kind>.py`` and ``counts/<kind>.py``: the kind's loss in the
  float64 reference, and the work its epoch adds to the circuit's;
- ``limits/<cell>.json``: the limit of each number ``correct`` compares;
- ``metrics/<metric>.py``: one reader per metric, ``read(run)`` -> a
  number, or None where it finds nothing to read;
- ``layers/*.json``: each names a layer and some of the program's modules
  that make it up, for the trace's attribution (files naming one layer add
  up); ``peaks.json``: the device's peak rates (the FP32 one is the
  yardstick of every roofline and of ``epoch_mfu``).

A run: set-up (the problem from the seed, the program's engine with the
benchmark's starting angles, the first steps that the reference follows,
two more epochs that warm the path and give the rate that sizes the
window), then the window (one ``train`` call of the epochs that fill
``seconds`` at that rate, ending in a device sync), then the checks (the
program's state freed, the reference follows the first steps in float64)
and the result line.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tensornetworks_tpu")
WARM_EPOCHS = 2
FIRST_STEPS = 3   # the training steps the reference follows


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    if not path.exists():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class CellSpec:
    name: str
    cell: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = ROOT


def find_cell(name: str, bench_path: Optional[Path] = None, root: Path = ROOT) -> CellSpec:
    bench = load_json(bench_path or root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root.parent / configs[cell["config"]]["file"])
    traffic = load_json(root / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(root / "limits" / f"{name}.json")

    def applies(m):
        return name in m.get("workloads", [name])

    return CellSpec(name, cell, config, traffic, limits,
                    [m for m in bench["end_to_end"] if applies(m)],
                    [m for m in bench["per_layer"] if applies(m)], root)


def load_layers(root: Path = ROOT) -> Dict[str, dict]:
    """{layer: {"modules": [...]}} from every ``layers/*.json``."""
    layers: Dict[str, dict] = {}
    for path in sorted((root / "layers").glob("*.json")):
        entry = load_json(path)
        layers.setdefault(entry["layer"], {"modules": []})["modules"] += entry["modules"]
    return layers


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


@dataclass
class Run:
    """What the metric readers read."""
    spec: CellSpec
    problem: dict
    work: dict
    epochs: int
    window_s: float
    setup_s: float
    peak_bytes: int
    peak: dict
    trace: object = None

    @property
    def peak_flops(self) -> Optional[float]:
        return self.peak.get("fp32_flops")

    @property
    def peak_bytes_per_s(self) -> Optional[float]:
        return self.peak.get("hbm_bytes_per_s")

    def roofline(self, layer: str, work_key: str) -> Optional[float]:
        """Percent of the least time of ``work_key``'s work over the
        window's epochs, against the device time of ``layer``."""
        t = self.trace.layer_s.get(layer, 0.0) if self.trace else 0.0
        w = self.work.get(work_key)
        if t <= 0 or w is None or not self.peak_flops or not self.peak_bytes_per_s:
            return None
        least = max(w["flops"] / self.peak_flops, w["bytes"] / self.peak_bytes_per_s)
        return 100.0 * least * self.epochs / t


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(spec: CellSpec, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", require_chip: bool = True, log=print) -> dict:
    """One run; returns the result line's object (and ``checks``)."""
    config = spec.config
    os.environ["TNTPU_KERNEL_PRECISION"] = config["kernel_precision"]
    os.environ["TNTPU_MATMUL_PRECISION"] = config["matmul_precision"]
    import torch

    from . import counts
    from .problem import make_problem

    if require_chip:
        chips = int(spec.cell["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise ChipMissing(f"this cell needs {chips} CUDA device(s); "
                              f"torch sees {torch.cuda.device_count()}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    from tensornetworks_tpu_torch.ops.kernels.precision import set_kernel_precision

    set_kernel_precision(config["kernel_precision"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    problem = make_problem(config, spec.traffic, seed)
    driver_mod = load_module(spec.root / "drivers" / f"{config['driver']}.py",
                             f"portbench_driver_{config['driver']}")
    t_build = time.perf_counter()
    driver = driver_mod.DRIVER(problem, dev)
    t_steps = time.perf_counter()
    record = driver.first_steps(FIRST_STEPS)
    t = time.perf_counter()
    epochs, rate, hist = 0, 0.0, {}
    if seconds > 0:
        driver.train(WARM_EPOCHS)
        _sync(dev)
        rate = WARM_EPOCHS / (time.perf_counter() - t)
        epochs = max(1, int(round(seconds * rate)))
    log(f"set-up: to the driver {t_build - t_start:.3f} s, driver {t_steps - t_build:.3f} s, "
        f"first steps {t - t_steps:.3f} s, warm epochs {time.perf_counter() - t:.3f} s")

    reduced = None
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from .trace import WINDOW, load, reduce_trace

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts, with_stack=True) as prof:
            with record_function(WINDOW):
                t0 = time.perf_counter()
                hist = driver.train(epochs)
                _sync(dev)
                t1 = time.perf_counter()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            del prof
            reduced = reduce_trace(load(path), load_layers(spec.root))
        finally:
            os.remove(path)
    elif epochs:
        hist = driver.train(epochs)
        _sync(dev)
        t1 = time.perf_counter()
    else:
        t1 = t0
    window_s = t1 - t0
    peak_bytes = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    record.update(driver.end_state())
    driver.close()
    del driver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"modules loaded that the port must not load: {found}")

    from .reference.check import follow

    t_ref = time.perf_counter()
    numbers = follow(problem, record, dev)
    ref_s = time.perf_counter() - t_ref
    checks = {k: {"value": numbers[k], "limit": float(v)} for k, v in spec.limits.items()}
    correct = all(k in numbers and math.isfinite(numbers[k]) and numbers[k] <= v
                  for k, v in spec.limits.items())
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peaks = load_json(spec.root / "peaks.json").get(kind, {})
    run = Run(spec, problem, counts.epoch_work(problem), epochs, window_s, setup_s,
              peak_bytes, peaks, reduced)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end) if epochs else ():
        value = load_module(spec.root / "metrics" / f"{m['name']}.py",
                            f"portbench_metric_{m['name'].replace('.', '_')}").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    skipped = int(hist.get("num_skipped_updates", 0))
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": int(spec.cell["chips"]), "memory_peak_bytes": peak_bytes}
    if trace and reduced is not None:
        device_info["busy_s"] = reduced.busy_s
        device_info["window_s"] = reduced.window_s
    limit = power_limit() if dev.type == "cuda" else None
    if limit:
        device_info["power"] = limit
    log(f"cell {spec.name} seed {seed}: {epochs} epochs in {window_s:.4f} s, set-up "
        f"{setup_s:.3f} s, warm rate {rate:.4f} epochs/s, reference {ref_s:.2f} s, "
        f"device {kind} ({limit})")
    if reduced is not None:
        for layer, ks in sorted(reduced.kernels_by_layer.items()):
            log(f"  layer {layer}: {reduced.layer_s[layer]:.6f} s; " + "; ".join(
                f"{name[:90]} {s:.6f}" for name, s in ks[:6]))
    for k, v in numbers.items():
        if k not in checks:
            log(f"  {k} = {v!r} (not compared)")
    result = {"correct": bool(correct), "attempted": epochs, "failed": skipped,
              "metrics": metrics, "device": device_info}
    if trace and reduced is not None:
        result["breakdown"] = {"device_ops": [[k, v] for k, v in reduced.device_ops],
                               "idle_gaps": [[k, v] for k, v in reduced.idle_gaps]}
        result["layers_s"] = reduced.layer_s
    result["numbers"] = numbers
    result["checks"] = checks
    return result


class ChipMissing(RuntimeError):
    pass


class ForbiddenImport(RuntimeError):
    pass
