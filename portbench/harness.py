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
two more epochs that warm the path, and, where those took less than
``WARM_S``, one more call of as many warm epochs as would fill ``WARM_S``
at their rate, whose own rate, read past the first epochs' costs, sizes
the window), then the window (one ``train`` call
of the epochs that fill ``seconds`` at that rate, ending in a device sync),
then the checks (the program's state freed, the reference follows the
first steps in float64) and the result line. A traced run sizes its
window from the two warm epochs alone, as its trace takes several times
the window to read.

A cell on D > 1 chips runs one rank a device. This process is rank 0 on
``cuda:0``: it owns the window's clock, the profiler and the result line.
``Ranks`` starts ranks 1..D-1 as ``torch.multiprocessing`` spawn processes
on ``cuda:1..D-1``, all in one process group (NCCL; gloo on the CPU) from
a FileStore in a temporary directory. Every rank builds the same problem
from the seed and its own driver, and runs set-up, the first steps, the
warm epochs and the window in lockstep: rank 0 sizes the window and hands
the counts of warm epochs and of the window's epochs over the store, and the window closes once every rank has
synced its device and passed a barrier. ``memory_peak_bytes`` is the
fullest device's. Each rank hands rank 0 its block of q (the driver names
its range of the state's index) through a ``torch.multiprocessing`` queue,
a copy on its own device with nothing written to disk, and ends before
the reference runs with its state in one block a device.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tensornetworks_tpu")
WARM_EPOCHS = 2
WARM_S = 1.0      # the least time the warm epochs take before their rate sizes an untraced window
FIRST_STEPS = 3   # the training steps the reference follows
COLLECTIVE_S = 180.0   # a cell on several chips: the longest a rank waits for its peers
JOIN_S = 60.0          # ... and for the ranks to end once the group closes
RANK_FAILED = 5        # the exit code of a run whose rank failed


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
    chips: int = 1

    @property
    def peak_flops(self) -> Optional[float]:
        return self.peak.get("fp32_flops")

    @property
    def peak_bytes_per_s(self) -> Optional[float]:
        return self.peak.get("hbm_bytes_per_s")

    def roofline(self, layer: str, work_key: str) -> Optional[float]:
        """Percent of the least time of ``work_key``'s work over the
        window's epochs, against the device time of ``layer``: rank 0's
        trace against rank 0's share of the work (the work over ``chips``)."""
        t = self.trace.layer_s.get(layer, 0.0) if self.trace else 0.0
        w = self.work.get(work_key)
        if t <= 0 or w is None or not self.peak_flops or not self.peak_bytes_per_s:
            return None
        least = max(w["flops"] / self.peak_flops, w["bytes"] / self.peak_bytes_per_s)
        return 100.0 * least * self.epochs / self.chips / t


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _planted(faults):
    """The named faults of ``faults.py`` planted for as long as it is open."""
    if not faults:
        yield
        return
    from .faults import planted

    with contextlib.ExitStack() as stack:
        for fault in faults:
            stack.enter_context(planted(fault))
        yield


def _prepare(config: dict):
    """The precisions the configuration states, before the program loads."""
    os.environ["TNTPU_KERNEL_PRECISION"] = config["kernel_precision"]
    os.environ["TNTPU_MATMUL_PRECISION"] = config["matmul_precision"]


def _set_precision(config: dict):
    from tensornetworks_tpu_torch.ops.kernels.precision import set_kernel_precision

    set_kernel_precision(config["kernel_precision"])


def _barrier(device):
    import torch.distributed as dist

    if device.type == "cuda":
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()


def _join_group(rank: int, world: int, device, tmp: str):
    """This process as ``rank`` of a group of ``world`` from a FileStore in
    ``tmp``: NCCL on CUDA, gloo on the CPU."""
    import datetime

    import torch.distributed as dist

    store = dist.FileStore(os.path.join(tmp, "store"), world)
    store.set_timeout(datetime.timedelta(seconds=COLLECTIVE_S))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", store=store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=COLLECTIVE_S))
    return store


def _rank_main(rank: int, spec: CellSpec, seed: int, seconds: float, world: int,
               device_type: str, tmp: str, faults, queue, parent: int):
    """Rank ``rank`` > 0 of a cell on ``world`` devices: the same set-up,
    first steps, warm epochs, window and end state as rank 0, in lockstep
    with it; its peak memory through the store and its block of q through
    ``queue``. Any failure prints its traceback and ends the process."""
    try:
        threading.Thread(target=_watch_parent, args=(parent,), daemon=True).start()
        config = spec.config
        _prepare(config)
        import torch
        import torch.distributed as dist

        from .problem import make_problem

        dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        _set_precision(config)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        store = _join_group(rank, world, dev, tmp)
        with _planted(faults):
            problem = make_problem(config, spec.traffic, seed)
            driver = load_module(spec.root / "drivers" / f"{config['driver']}.py",
                                 f"portbench_driver_{config['driver']}").DRIVER(problem, dev)
            driver.first_steps(FIRST_STEPS)
            if seconds > 0:
                driver.train(WARM_EPOCHS)
                more = int(store.get("warm"))
                if more:
                    driver.train(more)
                driver.train(int(store.get("epochs")))
                _sync(dev)
                _barrier(dev)
            peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
            store.set(f"peak_{rank}", str(peak))
            state = driver.end_state()
            driver.close()
        queue.put((state["q_range"], state["q_end"]))
        _barrier(dev)   # rank 0 holds a copy of every block
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _watch_parent(parent: int):
    """Ends this rank when the process that started it is gone."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


class Ranks:
    """Ranks 1..D-1 of a cell on D devices, started by rank 0 (this
    process) as ``torch.multiprocessing`` spawn processes, rank r on device
    r, all in one process group. A rank that fails ends the run: every
    rank is killed and this process exits with ``RANK_FAILED``."""

    def __init__(self, spec: CellSpec, seed: int, seconds: float, world: int, device,
                 faults=()):
        import torch.multiprocessing as mp

        self.world, self.device = world, device
        self.tmp = tempfile.mkdtemp(prefix="portbench_ranks_")
        ctx = mp.get_context("spawn")
        self.queue = ctx.SimpleQueue()
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(r, spec, seed, seconds, world, device.type, self.tmp,
                                        tuple(faults), self.queue, os.getpid()))
                      for r in range(1, world)]
        for p in self.procs:
            p.start()
        self._done = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()
        self.store = _join_group(0, world, device, self.tmp)

    def _failed(self) -> bool:
        """Whether a rank has failed; says which on standard error."""
        for rank, p in enumerate(self.procs, 1):
            if p.exitcode not in (None, 0):
                sys.stderr.write(f"rank {rank} of {self.world} failed (exit code {p.exitcode}; "
                                 f"its traceback is above): ending every rank\n")
                sys.stderr.flush()
                return True
        return False

    def _watch(self):
        while not self._done.wait(0.2):
            if self._failed():
                self.kill()
                os._exit(RANK_FAILED)

    def kill(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(timeout=10)
        shutil.rmtree(self.tmp, ignore_errors=True)

    def abort(self):
        """On a failure that reached rank 0: no more watching, every rank
        killed."""
        self._done.set()
        self._failed()
        self.kill()

    def share(self, key: str, count: int):
        """A count that rank 0 decided (``warm``, ``epochs``), for every rank."""
        self.store.set(key, str(count))

    def barrier(self):
        _barrier(self.device)

    def peaks(self, own: int) -> List[int]:
        """Every rank's peak device memory, in rank order."""
        return [own] + [int(self.store.get(f"peak_{r}")) for r in range(1, self.world)]

    def blocks(self, own_range, own_q) -> list:
        """q's blocks in the order of the state's index: this rank's, and a
        copy of each other rank's; the other ranks then free theirs."""
        import torch

        got = {tuple(own_range): own_q}
        for _ in range(1, self.world):
            rng, q = self.queue.get()
            got[tuple(rng)] = q.clone()
            del q
        if self.device.type == "cuda":
            for d in range(self.world):
                torch.cuda.synchronize(d)
        self.barrier()
        ranges = sorted(got)
        if [r[0] for r in ranges] != [0] + [r[1] for r in ranges[:-1]] or len(
                {r[1] - r[0] for r in ranges}) != 1:
            raise ValueError(f"the ranks' blocks of q are not consecutive and equal: {ranges}")
        return [got[r] for r in ranges]

    def finish(self):
        """The group closed and every rank ended (each within JOIN_S)."""
        import torch.distributed as dist

        self._done.set()
        dist.destroy_process_group()
        for p in self.procs:
            p.join(timeout=JOIN_S)
        codes = [p.exitcode for p in self.procs]
        self.kill()
        if codes != [0] * len(codes):
            raise RuntimeError(f"ranks 1..{self.world - 1} ended with exit codes {codes}")


def run_cell(spec: CellSpec, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", require_chip: bool = True, log=print, faults=()) -> dict:
    """One run; returns the result line's object (and ``checks``). A cell
    on D > 1 chips runs one rank a device (``Ranks``); ``faults`` names
    faults of ``faults.py`` planted in every rank."""
    _prepare(spec.config)
    import torch

    chips = int(spec.cell["chips"])
    if require_chip:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise ChipMissing(f"this cell needs {chips} CUDA device(s); "
                              f"torch sees {torch.cuda.device_count()}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0 if chips > 1 else torch.cuda.current_device())
    ranks = Ranks(spec, seed, seconds, chips, dev, faults) if chips > 1 else None
    try:
        return _run(spec, seed, seconds, trace, t_start, dev, chips, ranks, faults, log)
    except BaseException:
        if ranks is not None:
            ranks.abort()
        raise


def _run(spec, seed, seconds, trace, t_start, dev, chips, ranks, faults, log) -> dict:
    import torch

    from . import counts
    from .problem import make_problem

    config = spec.config
    _set_precision(config)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with _planted(faults):
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
            took = time.perf_counter() - t
            rate = WARM_EPOCHS / took
            more = 0 if trace or took >= WARM_S else math.ceil(WARM_S * rate)
            if ranks is not None:
                ranks.share("warm", more)
            if more:
                t_more = time.perf_counter()
                driver.train(more)
                _sync(dev)
                rate = more / (time.perf_counter() - t_more)
            epochs = max(1, int(round(seconds * rate)))
            if ranks is not None:
                ranks.share("epochs", epochs)
        log(f"set-up: to the driver {t_build - t_start:.3f} s, driver {t_steps - t_build:.3f} s, "
            f"first steps {t - t_steps:.3f} s, warm epochs {time.perf_counter() - t:.3f} s")

        prof = None
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            from .trace import WINDOW

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with profile(activities=acts, with_stack=True) as prof:
                with record_function(WINDOW):
                    t0 = time.perf_counter()
                    hist = driver.train(epochs)
                    _sync(dev)
                    if ranks is not None:
                        ranks.barrier()
                    t1 = time.perf_counter()
        elif epochs:
            hist = driver.train(epochs)
            _sync(dev)
            if ranks is not None:
                ranks.barrier()
            t1 = time.perf_counter()
        else:
            t1 = t0
        window_s = t1 - t0
        peak_bytes = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
        peaks = ranks.peaks(peak_bytes) if ranks is not None else [peak_bytes]
        record.update(driver.end_state())
        driver.close()
        del driver
    if ranks is not None:
        record["q_end"] = ranks.blocks(record.pop("q_range"), record["q_end"])
        ranks.finish()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reduced = None
    if prof is not None:
        from .trace import load, reduce_trace

        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            del prof
            reduced = reduce_trace(load(path), load_layers(spec.root))
        finally:
            os.remove(path)
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"modules loaded that the port must not load: {found}")

    from .reference.check import follow

    if chips > 1 and dev.type == "cuda":
        ref_devices = [torch.device("cuda", r) for r in range(chips)]
    else:
        ref_devices = [dev] * chips
    t_ref = time.perf_counter()
    numbers = follow(problem, record, ref_devices)
    ref_s = time.perf_counter() - t_ref
    checks = {k: {"value": numbers[k], "limit": float(v)} for k, v in spec.limits.items()}
    correct = all(k in numbers and math.isfinite(numbers[k]) and numbers[k] <= v
                  for k, v in spec.limits.items())
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peaks_json = load_json(spec.root / "peaks.json").get(kind, {})
    peak_bytes = max(peaks)
    run = Run(spec, problem, counts.epoch_work(problem), epochs, window_s, setup_s,
              peak_bytes, peaks_json, reduced, chips)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end) if epochs else ():
        value = load_module(spec.root / "metrics" / f"{m['name']}.py",
                            f"portbench_metric_{m['name'].replace('.', '_')}").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    skipped = int(hist.get("num_skipped_updates", 0))
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": chips, "memory_peak_bytes": peak_bytes}
    if ranks is not None:
        device_info["memory_peak_bytes_per_device"] = peaks
    if trace and reduced is not None:
        device_info["busy_s"] = reduced.busy_s
        device_info["window_s"] = reduced.window_s
    limit = power_limit() if dev.type == "cuda" else None
    if limit:
        device_info["power"] = limit
    log(f"cell {spec.name} seed {seed}: {epochs} epochs in {window_s:.4f} s, set-up "
        f"{setup_s:.3f} s, warm rate {rate:.4f} epochs/s, reference {ref_s:.2f} s, "
        f"device {kind} ({limit})")
    if ranks is not None:
        log(f"  {chips} ranks, peak bytes by device {peaks}")
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
