"""Inside the circuit kernels redesigned for Hopper, on the card.

    python -m tensornetworks_tpu_torch.runners.probe_kernels
        [--layers 8] [--ansatz bn_structured] [--precision highest,high,default]

1. The n=16 persistent backward and forward at each precision: the FP32
   kernels and the forward's bf16 variants (``csrc/circuit2d_bwd.cuh``,
   ``csrc/circuit2d_fwd.cuh``, their units in ``csrc/circuit_units.cuh``)
   and the backward's bf16 kernel (``csrc/circuit_bf16.cuh``), rebuilt from
   a copy of the sources (``build/probe/``) with ``%globaltimer`` stamps
   added to the copy only, never to the package's kernels: per phase, the
   blocks' busy time and the grid barrier's latency (last arrival to first
   release); per GEMM unit, the wait for its first tile (K piece), the rest
   of its K loop, and its K-split sum with the store, and the producer
   thread's time issuing TMA copies. Each copy is checked against its plain
   version first.
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
# per block: first-tile wait, rest of the K loops, K-split sums and stores,
# units, copies' issue (the bf16 backward's producer thread)
UNIT_SLOTS = 5

# Text edits that add the stamps to the copies of csrc/circuit_units.cuh
# (the clock, the stamp tables and the per-unit stamps) and of the two
# persistent kernels (per-phase stamps).
_UNIT_STAMPS = [
    ("namespace unit {\n",
     "namespace unit {\n"
     f"constexpr int UNIT_SLOTS = {UNIT_SLOTS};\n"
     f"__device__ unsigned long long g_phase[{MAX_BLOCKS} * {SLOTS}];\n"
     f"__device__ unsigned long long g_unit[{MAX_BLOCKS} * UNIT_SLOTS];\n"
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
     "  if (threadIdx.x == 0) {\n    unsigned long long* u = g_unit + blockIdx.x * UNIT_SLOTS;\n"
     "    atomicAdd(u, t1 - t0); atomicAdd(u + 1, t2 - t1); atomicAdd(u + 2, gtime() - t2);\n"
     "    atomicAdd(u + 3, 1ull);\n  }\n"),
]
_MARK = ("  cg::grid_group grid = cg::this_grid();\n",
         "  cg::grid_group grid = cg::this_grid();\n  int slot = 0;\n"
         "  auto mark = [&]() {\n"
         f"    if (threadIdx.x == 0 && slot < {SLOTS})\n"
         f"      unit::g_phase[blockIdx.x * {SLOTS} + slot] = unit::gtime();\n"
         "    ++slot;\n  };\n  mark();\n")
_BARRIER = ("grid.sync();", "mark(); grid.sync(); mark();")
_BWD_STAMPS = [_MARK, _BARRIER, ("  grads(0);\n}", "  grads(0);\n  mark();\n}")]
_FWD_STAMPS = [_MARK, _BARRIER,
               ("    if (last) break;\n", "    if (last) {\n      mark();\n      break;\n    }\n")]
# The bf16 backward: its marks and barriers, and the stamps of its units
# (product()).
_BF16_STAMPS = [
    _MARK, _BARRIER,
    ("  grads(0);\n}", "  grads(0);\n  mark();\n}"),
    ("  const int steps = kp / 16, np = pieces(kp);\n",
     "  const int steps = kp / 16, np = pieces(kp);\n"
     "  const unsigned long long t0 = unit::gtime();\n  unsigned long long t1 = t0;\n"),
    ("    const int s0 = piece_step(steps, np, p), s1 = piece_step(steps, np, p + 1);\n",
     "    if (p == 0) t1 = unit::gtime();\n"
     "    const int s0 = piece_step(steps, np, p), s1 = piece_step(steps, np, p + 1);\n"),
    ("  const int g = lane >> 2, t2 = 2 * (lane & 3);\n",
     "  const unsigned long long t2s = unit::gtime();\n"
     "  const int g = lane >> 2, t2 = 2 * (lane & 3);\n"),
    ("  if (threadIdx.x != PRODUCER) return;\n",
     "  if (threadIdx.x != PRODUCER) return;\n  const unsigned long long ti = unit::gtime();\n"),
    ("    tma_load(l.t.base + blk * l.t.block, l.map, &bars[p], c0, c1, l.c_plane);\n  }\n}\n",
     "    tma_load(l.t.base + blk * l.t.block, l.map, &bars[p], c0, c1, l.c_plane);\n  }\n"
     "  atomicAdd(unit::g_unit + blockIdx.x * unit::UNIT_SLOTS + 4, unit::gtime() - ti);\n}\n"),
    ("  __syncthreads();\n}\n\n// The first element of item c",
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0) {\n"
     "    unsigned long long* u = unit::g_unit + blockIdx.x * unit::UNIT_SLOTS;\n"
     "    atomicAdd(u, t1 - t0); atomicAdd(u + 1, t2s - t1); atomicAdd(u + 2, unit::gtime() - t2s);\n"
     "    atomicAdd(u + 3, 1ull);\n  }\n}\n\n// The first element of item c"),
]
_EXPORT = ("}  // extern \"C\"",
           "int tn_probe_read(unsigned long long* phase, unsigned long long* unit) {\n"
           "  using namespace tn::unit;\n"
           "  cudaError_t e = cudaMemcpyFromSymbol(phase, g_phase, sizeof(g_phase));\n"
           "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(unit, g_unit, sizeof(g_unit));\n"
           "  return e;\n}\n"
           "int tn_probe_clear() {\n"
           "  static unsigned long long z[sizeof(tn::unit::g_phase) / 8] = {};\n"
           "  cudaError_t e = cudaMemcpyToSymbol(tn::unit::g_unit, z, sizeof(tn::unit::g_unit));\n"
           "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(tn::unit::g_phase, z, sizeof(z));\n"
           "  return e;\n}\n"
           "}  // extern \"C\"")

# The edits by file of csrc/.
EDITS = (("circuit_units.cuh", _UNIT_STAMPS), ("circuit2d_bwd.cuh", _BWD_STAMPS),
         ("circuit2d_fwd.cuh", _FWD_STAMPS), ("circuit_bf16.cuh", _BF16_STAMPS),
         ("circuit2d.cu", [_EXPORT]))


def sites(name: str, old: str) -> int:
    """How often the text ``old`` an edit replaces stands in csrc/``name``:
    the grid barriers three times a kernel, every other site once."""
    return 3 if old == _BARRIER[0] else 1


def _build_probe() -> ctypes.CDLL:
    src = PROBE_DIR / "csrc"
    shutil.rmtree(src.parent, ignore_errors=True)
    shutil.copytree(_lib.CSRC, src)
    for fname, file_edits in EDITS:
        text = (src / fname).read_text()
        for old, new in file_edits:
            if old not in text:
                raise RuntimeError(f"probe: {fname} no longer holds {old.strip()[:40]!r}")
            text = text.replace(old, new)
        (src / fname).write_text(text)
    out = src.parent / "libcircuit2d_probe.so"
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-o", str(out), str(src / "circuit2d.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _lib.SIGNATURES["circuit2d"].items():
        getattr(lib, fn).argtypes = argtypes
    lib.tn_probe_read.argtypes = [ctypes.c_void_p] * 2
    for fn in (lib.tn_circuit2d_forward, lib.tn_circuit2d_backward, lib.tn_probe_read,
               lib.tn_probe_clear):
        fn.restype = ctypes.c_int
    lib.tn_circuit2d_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _probe(lib, call, barriers: int, reps: int) -> dict:
    """Per-phase and per-unit times of ``reps`` calls of a stamped kernel
    with ``barriers`` grid barriers (the phases of the last call)."""
    _lib.check(lib.tn_probe_clear(), "probe clear")
    for _ in range(reps):
        _lib.check(call(), "probe call")
    torch.cuda.synchronize()
    phase = np.zeros(MAX_BLOCKS * SLOTS, dtype=np.uint64)
    unit = np.zeros(MAX_BLOCKS * UNIT_SLOTS, dtype=np.uint64)
    _lib.check(lib.tn_probe_read(phase.ctypes.data, unit.ctypes.data), "probe read")
    t = phase.reshape(MAX_BLOCKS, SLOTS).astype(np.int64)  # the last call's stamps
    blocks = int((t[:, 0] > 0).sum())  # the launch's blocks (cleared before the calls)
    t = t[:blocks]
    t -= t[:, 0].min()
    phases = []
    for k in range(barriers + 1):
        start, end = (t[:, 0] if k == 0 else t[:, 2 * k]), t[:, 2 * k + 1]
        row = {"busy_us_median": float(np.median(end - start)) / 1e3,
               "busy_us_max": float((end - start).max()) / 1e3}
        if k < barriers:
            row["barrier_us"] = float(t[:, 2 * k + 2].min() - end.max()) / 1e3
        phases.append(row)
    u = unit.reshape(MAX_BLOCKS, UNIT_SLOTS)[:blocks].astype(np.float64)
    per_call = np.median(u, axis=0) / reps / 1e3
    return {"total_us": float(t[:, 2 * barriers + 1].max()) / 1e3, "phases": phases,
            "units_per_block": float(np.median(u[:, 3])) / reps,
            "first_tile_wait_us": float(per_call[0]), "k_loop_us": float(per_call[1]),
            "ksplit_sum_store_us": float(per_call[2]), "tma_issue_us": float(per_call[4])}


def _rel(got, want) -> float:
    return max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want))


def barriers(precision: str, layers: int, backward: bool) -> int:
    """Grid barriers a call of the n <= 17 kernel waits at, at every
    precision: 2L - 1 (forward) and 3L (backward)."""
    return 3 * layers if backward else 2 * layers - 1


def probe_circuit(layers: int = 8, reps: int = 10, precision: str = "highest",
                  ansatz: str = "bn_structured", lib=None) -> dict:
    """The stamped n=16 backward and forward at a precision and ansatz, each checked
    against its plain version first (FP32 1e-4, ``high`` 1e-4, ``default``
    2e-2 of the largest value): {"backward": ..., "forward": ...}."""
    from ..runners import make_scale_problem
    from ..sim.structured import latent_edges

    lib = lib or _build_probe()
    dev, n = torch.device("cuda"), 16
    # bn_structured: the DAG of the 16-qubit scale problem (bench16's, seed 0)
    edges = (latent_edges(*make_scale_problem(n, seed=0)[:2]) if ansatz == "bn_structured"
             else None)
    plan = kc.CircuitPlan(n, layers, ansatz, edges, precision=precision)
    gen = torch.Generator().manual_seed(n)
    theta = (0.1 * torch.randn(3 * layers * n, generator=gen)).to(dev)
    Mr, Mc = rotation_operators(theta, n, layers, plan.per_qubit)
    planes = [t.contiguous() for t in (Mr.real, Mr.imag, Mc.real, Mc.imag)]
    want_fwd = kc.circuit2d_forward_plain(*planes, plan)
    _, xr, xi = want_fwd
    g = torch.randn((plan.R, plan.C), generator=gen).to(dev)
    P, masks, stream = _lib.ptr, plan.device_masks(dev), _lib.stream_ptr(dev)
    code = CODES[precision]

    def scratch(backward):
        nbytes = lib.tn_circuit2d_scratch_bytes(n, layers, int(backward), code)
        return torch.empty(-(-nbytes // 4), device=dev)

    grads = [torch.empty_like(t) for t in planes]
    bwd_scratch, tmp = scratch(True), scratch(False)
    bwd_args = [*map(P, planes), P(xr), P(xi), P(g), *map(P, grads), P(bwd_scratch), P(masks),
                n, layers, code, stream]
    out = [torch.empty((plan.R, plan.C), device=dev) for _ in range(3)]
    fwd_args = [*map(P, planes), *map(P, out), P(tmp), P(masks), n, layers,
                int(plan.has_wall), code, stream]
    tol = 2e-2 if precision == "default" else 1e-4
    result = {}
    for name, call, want in (("backward", lambda: lib.tn_circuit2d_backward(*bwd_args), grads),
                             ("forward", lambda: lib.tn_circuit2d_forward(*fwd_args), out)):
        _lib.check(call(), f"probe {name}")
        plain = (kc.circuit2d_backward_plain(*planes, xr, xi, g, plan) if name == "backward"
                 else want_fwd)
        rel = _rel(want, plain)
        if rel > tol:
            raise RuntimeError(f"probe {name} {precision} disagrees with the plain version: "
                               f"rel {rel:.2e}")
        nb = barriers(precision, layers, name == "backward")
        result[name] = {"rel_err": rel, "barriers": nb, **_probe(lib, call, nb, reps)}
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


def _print(name, precision, ansatz, layers, b) -> None:
    print(f"circuit2d {name} {precision}, n=16, {ansatz} L={layers}: "
          f"{b['total_us']:.2f} us from the first block's start to the last block's "
          f"end, {b['barriers']} grid barriers (rel err {b['rel_err']:.1e})")
    for k, row in enumerate(b["phases"]):
        extra = f", barrier {row['barrier_us']:.2f} us" if "barrier_us" in row else ""
        print(f"  phase {k:2d}: busy median {row['busy_us_median']:.2f} us, "
              f"max {row['busy_us_max']:.2f} us{extra}")
    print(f"  per call and block ({b['units_per_block']:.0f} GEMM units): first-tile "
          f"wait {b['first_tile_wait_us']:.2f} us, rest of the K loops "
          f"{b['k_loop_us']:.2f} us, K-split sums and stores "
          f"{b['ksplit_sum_store_us']:.2f} us, TMA issue {b['tma_issue_us']:.2f} us (the producer "
          f"thread)", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--ansatz", default="bn_structured")
    ap.add_argument("--precision", default="highest,high,default",
                    help="comma-separated kernel precisions")
    ap.add_argument("--no-grid", action="store_true", help="skip the n=20 grid forward")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    lib = _build_probe()
    for precision in args.precision.split(","):
        res = probe_circuit(args.layers, precision=precision, ansatz=args.ansatz, lib=lib)
        for name, b in res.items():
            _print(name, precision, args.ansatz, args.layers, b)
    if args.no_grid:
        return
    print(f"circuit2d_grid forward, n=20, L={args.layers}: device us per call by kernel")
    for name, us in sorted(profile_grid_forward(args.layers).items(), key=lambda kv: -kv[1]):
        print(f"  {us:9.1f}  {name[:90]}")


if __name__ == "__main__":
    main()
