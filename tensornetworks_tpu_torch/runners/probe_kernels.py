"""Inside the circuit kernels redesigned for Hopper, on the card.

    python -m tensornetworks_tpu_torch.runners.probe_kernels [--layers 4]

1. The n=16 persistent backward and forward (``csrc/circuit2d_bwd.cuh``,
   ``csrc/circuit2d_fwd.cuh``, their units in ``csrc/circuit_units.cuh``),
   rebuilt from a copy of the sources (``build/probe/``) with
   ``%globaltimer`` stamps added to the copy only, never to the package's
   kernels: per phase, the blocks' busy time and the grid barrier's latency
   (last arrival to first release); per GEMM unit, the wait for its first
   tile, the rest of its K loop, and its K-split sum with the store. Each
   copy is checked against its plain version first.
2. The n=20 grid forward (``csrc/circuit2d_grid.cu``) through the package:
   device time per kernel by ``torch.profiler`` (left products, scatter
   products, the Mc transpose, the state init).

Runs in a process of its own: it must not have loaded the package's
circuit2d library. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess

import numpy as np
import torch

from ..ops.kernels import _lib
from ..ops.kernels import circuit2d as kc
from ..ops.kernels import circuit2d_grid as kg
from ..ops.kernels.precision import CODES
from ..sim.gates import rotation_operators

PROBE_DIR = _lib.BUILD_DIR.parent / "probe"
MAX_BLOCKS, SLOTS = 1024, 64

# Text edits that add the stamps to the copies of csrc/circuit_units.cuh
# (the clock, the stamp tables and the per-unit stamps) and of the two
# persistent kernels (per-phase stamps).
_UNIT_STAMPS = [
    ("namespace unit {\n",
     "namespace unit {\n"
     f"__device__ unsigned long long g_phase[{MAX_BLOCKS} * {SLOTS}];\n"
     f"__device__ unsigned long long g_unit[{MAX_BLOCKS} * 4];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t; asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t)); return t;\n"
     "}\n"),
    ("  issue(0);\n", "  const unsigned long long t0 = gtime();\n  unsigned long long t1 = 0;\n"
                      "  issue(0);\n"),
    ("    __syncthreads();   // ... and every thread's\n",
     "    __syncthreads();   // ... and every thread's\n    if (s == 0) t1 = gtime();\n"),
    ("  // The K-split sum", "  const unsigned long long t2 = gtime();\n  // The K-split sum"),
    ("  __syncthreads();  // the ring is free for the next unit\n",
     "  __syncthreads();  // the ring is free for the next unit\n"
     "  if (threadIdx.x == 0) {\n    unsigned long long* u = g_unit + blockIdx.x * 4;\n"
     "    atomicAdd(u, t1 - t0); atomicAdd(u + 1, t2 - t1); atomicAdd(u + 2, gtime() - t2);\n"
     "    atomicAdd(u + 3, 1ull);\n  }\n"),
]
_MARK = ("  cg::grid_group grid = cg::this_grid();\n",
         "  cg::grid_group grid = cg::this_grid();\n  int slot = 0;\n"
         "  auto mark = [&]() {\n"
         f"    if (threadIdx.x == 0 && slot < {SLOTS})\n"
         f"      g_phase[blockIdx.x * {SLOTS} + slot] = gtime();\n"
         "    ++slot;\n  };\n  mark();\n")
_BARRIER = ("grid.sync();", "mark(); grid.sync(); mark();")
_BWD_STAMPS = [_MARK, _BARRIER, ("  grads(0);\n}", "  grads(0);\n  mark();\n}")]
_FWD_STAMPS = [_MARK, _BARRIER,
               ("    if (last) break;\n", "    if (last) {\n      mark();\n      break;\n    }\n")]
_EXPORT = ("}  // extern \"C\"",
           "int tn_probe_read(unsigned long long* phase, unsigned long long* unit) {\n"
           "  using namespace tn::unit;\n"
           "  cudaError_t e = cudaMemcpyFromSymbol(phase, g_phase, sizeof(g_phase));\n"
           "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(unit, g_unit, sizeof(g_unit));\n"
           "  return e;\n}\n"
           "int tn_probe_clear() {\n"
           "  static unsigned long long z[sizeof(tn::unit::g_unit) / 8] = {};\n"
           "  return cudaMemcpyToSymbol(tn::unit::g_unit, z, sizeof(z));\n}\n"
           "}  // extern \"C\"")

# The edits by file of csrc/.
EDITS = (("circuit_units.cuh", _UNIT_STAMPS), ("circuit2d_bwd.cuh", _BWD_STAMPS),
         ("circuit2d_fwd.cuh", _FWD_STAMPS), ("circuit2d.cu", [_EXPORT]))


def _build_probe() -> ctypes.CDLL:
    src = PROBE_DIR / "csrc"
    shutil.rmtree(PROBE_DIR, ignore_errors=True)
    shutil.copytree(_lib.CSRC, src)
    for name, edits in EDITS:
        text = (src / name).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"probe: {name} no longer holds {old.strip()[:40]!r}")
            text = text.replace(old, new)
        (src / name).write_text(text)
    out = PROBE_DIR / "libcircuit2d_probe.so"
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-o", str(out), str(src / "circuit2d.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _lib.SIGNATURES["circuit2d"].items():
        getattr(lib, fn).argtypes = argtypes
    lib.tn_probe_read.argtypes = [ctypes.c_void_p] * 2
    for fn in (lib.tn_circuit2d_forward, lib.tn_circuit2d_backward, lib.tn_probe_read,
               lib.tn_probe_clear):
        fn.restype = ctypes.c_int
    return lib


def _probe(lib, call, barriers: int, reps: int) -> dict:
    """Per-phase and per-unit times of ``reps`` calls of a stamped kernel
    with ``barriers`` grid barriers (the phases of the last call)."""
    _lib.check(lib.tn_probe_clear(), "probe clear")
    for _ in range(reps):
        _lib.check(call(), "probe call")
    torch.cuda.synchronize()
    phase = np.zeros(MAX_BLOCKS * SLOTS, dtype=np.uint64)
    unit = np.zeros(MAX_BLOCKS * 4, dtype=np.uint64)
    _lib.check(lib.tn_probe_read(phase.ctypes.data, unit.ctypes.data), "probe read")
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    t = phase.reshape(MAX_BLOCKS, SLOTS)[:blocks].astype(np.int64)  # the last call's stamps
    t -= t[:, 0].min()
    phases = []
    for k in range(barriers + 1):
        start, end = (t[:, 0] if k == 0 else t[:, 2 * k]), t[:, 2 * k + 1]
        row = {"busy_us_median": float(np.median(end - start)) / 1e3,
               "busy_us_max": float((end - start).max()) / 1e3}
        if k < barriers:
            row["barrier_us"] = float(t[:, 2 * k + 2].min() - end.max()) / 1e3
        phases.append(row)
    u = unit.reshape(MAX_BLOCKS, 4)[:blocks].astype(np.float64)
    per_call = np.median(u[:, :3], axis=0) / reps / 1e3
    return {"total_us": float(t[:, 2 * barriers + 1].max()) / 1e3, "phases": phases,
            "units_per_block": float(np.median(u[:, 3])) / reps,
            "first_tile_wait_us": float(per_call[0]), "k_loop_us": float(per_call[1]),
            "ksplit_sum_store_us": float(per_call[2])}


def _rel(got, want) -> float:
    return max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want))


def probe_circuit(layers: int = 4, reps: int = 10) -> dict:
    """The stamped n=16 backward and forward, each checked against its plain
    version first: {"backward": ..., "forward": ...}."""
    lib = _build_probe()
    dev, n = torch.device("cuda"), 16
    plan = kc.CircuitPlan(n, layers, "hardware_efficient", precision="highest")
    gen = torch.Generator().manual_seed(n)
    theta = (0.1 * torch.randn(3 * layers * n, generator=gen)).to(dev)
    Mr, Mc = rotation_operators(theta, n, layers, plan.per_qubit)
    planes = [t.contiguous() for t in (Mr.real, Mr.imag, Mc.real, Mc.imag)]
    want_fwd = kc.circuit2d_forward_plain(*planes, plan)
    _, xr, xi = want_fwd
    g = torch.randn((plan.R, plan.C), generator=gen).to(dev)
    P, masks, stream = _lib.ptr, plan.device_masks(dev), _lib.stream_ptr(dev)

    grads = [torch.empty_like(t) for t in planes]
    scratch = torch.empty((4, 4, plan.R, plan.C), device=dev)
    highest = CODES["highest"]
    bwd_args = [*map(P, planes), P(xr), P(xi), P(g), *map(P, grads), P(scratch), P(masks),
                n, layers, highest, stream]
    out = [torch.empty((plan.R, plan.C), device=dev) for _ in range(3)]
    tmp = torch.empty((2, plan.R, plan.C), device=dev)
    fwd_args = [*map(P, planes), *map(P, out), P(tmp), P(masks), n, layers,
                int(plan.has_wall), highest, stream]
    result = {}
    for name, call, want, barriers in (
            ("backward", lambda: lib.tn_circuit2d_backward(*bwd_args), grads, 3 * layers),
            ("forward", lambda: lib.tn_circuit2d_forward(*fwd_args), out, 2 * layers - 1)):
        _lib.check(call(), f"probe {name}")
        plain = (kc.circuit2d_backward_plain(*planes, xr, xi, g, plan) if name == "backward"
                 else want_fwd)
        rel = _rel(want, plain)
        if rel > 1e-4:
            raise RuntimeError(f"probe {name} disagrees with the plain version: rel {rel:.2e}")
        result[name] = {"rel_err": rel, **_probe(lib, call, barriers, reps)}
    return result


def profile_grid_forward(layers: int = 4, calls: int = 5) -> dict:
    from torch.profiler import ProfilerActivity, profile

    dev, n = torch.device("cuda"), 20
    plan = kg.GridPlan(n, layers, "hardware_efficient")
    theta = (0.1 * torch.randn(3 * layers * n, generator=torch.Generator().manual_seed(n)))
    planes = kg.grid_operators(theta.to(dev), plan)
    kg.circuit2d_grid_forward(*planes, plan)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            kg.circuit2d_grid_forward(*planes, plan)
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / calls for e in prof.key_averages()
            if e.device_time_total > 0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    for name, b in probe_circuit(args.layers).items():
        print(f"circuit2d {name}, n=16, L={args.layers}: {b['total_us']:.2f} us from the first "
              f"block's start to the last block's end (rel err {b['rel_err']:.1e})")
        for k, row in enumerate(b["phases"]):
            extra = f", barrier {row['barrier_us']:.2f} us" if "barrier_us" in row else ""
            print(f"  phase {k:2d}: busy median {row['busy_us_median']:.2f} us, "
                  f"max {row['busy_us_max']:.2f} us{extra}")
        print(f"  per call and block ({b['units_per_block']:.0f} GEMM units): first-tile wait "
              f"{b['first_tile_wait_us']:.2f} us, rest of the K loops {b['k_loop_us']:.2f} us, "
              f"K-split sums and stores {b['ksplit_sum_store_us']:.2f} us")
    print(f"circuit2d_grid forward, n=20, L={args.layers}: device us per call by kernel")
    for name, us in sorted(profile_grid_forward(args.layers).items(), key=lambda kv: -kv[1]):
        print(f"  {us:9.1f}  {name[:90]}")


if __name__ == "__main__":
    main()
