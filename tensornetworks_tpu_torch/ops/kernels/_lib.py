"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded through ``ctypes``. The build happens at
first use, into ``build/tn_kernels/`` beside the package (listed in
``.gitignore``); the library name carries a hash of the sources and flags,
so an edited source is never served from a stale build; the compiler's
report (``-Xptxas -v``) is kept beside it and read into ``BUILD_LOGS``
whether the library was built now or found built. ``build_all`` starts one
``nvcc`` per source at once and waits for all of them. The wait for a
build is a ``kernels.build`` span (``train.span``) in a profile.

Every C entry point returns ``cudaGetLastError()``; ``check`` raises on a
non-zero code. Launch counts are plain integers kept here, one per kernel
wrapper, so that a run can show which kernels its path went through; the
bf16 variants of the circuit kernels (kernel precision ``high`` and
``default``) count under their own keys, ``<kernel>.<precision>``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from ...train import span

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tn_kernels"
SOURCES = ("circuit2d", "circuit2d_grid", "circuit_gates", "stein2d", "stein_gcorr")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The circuit kernels with bf16 variants, and the variants' precisions.
PRECISION_KERNELS = ("circuit2d_fwd", "circuit2d_bwd", "circuit2d_grid_fwd",
                     "circuit2d_grid_bwd")
VARIANT_PRECISIONS = ("high", "default")

LAUNCHES: Dict[str, int] = {"circuit2d_fwd": 0, "circuit2d_bwd": 0, "stein2d": 0,
                            "circuit2d_grid_fwd": 0, "circuit2d_grid_bwd": 0, "stein2d_grid": 0,
                            "stein_gcorr": 0, "circuit_gates_fwd": 0, "circuit_gates_bwd": 0,
                            "gates_pass_fwd": 0, "gates_pass_bwd": 0, "pair_fwd": 0,
                            "pair_bwd": 0, "gates_reduce": 0}
LAUNCHES.update({f"{k}.{p}": 0 for k in PRECISION_KERNELS for p in VARIANT_PRECISIONS})

# The C interface of each library: pointers and the stream as c_void_p (a
# bare Python int would be passed as a 32-bit int), sizes as c_int; every
# entry point returns its cudaError_t, but those in RESTYPES.
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "circuit2d": {
        # mr_re, mr_im, mc_re, mc_im, probs, xr, xi, tmp, masks (device), n, layers,
        # has_wall, precision, stream
        "tn_circuit2d_forward": [_P] * 9 + [_I] * 4 + [_P],
        # mr_re, mr_im, mc_re, mc_im, xr, xi, g, dmr_re, dmr_im, dmc_re, dmc_im,
        # scratch, masks (device), n, layers, precision, stream
        "tn_circuit2d_backward": [_P] * 13 + [_I] * 3 + [_P],
        # n, layers, backward, precision -> bytes of the tmp / scratch argument
        "tn_circuit2d_scratch_bytes": [_I] * 4,
        # n, precision, sms, out (6 long long on the host) -> 0, or -1
        "tn_circuit2d_bwd_bf16_plan": [_I] * 3 + [_P],
    },
    "circuit2d_grid": {  # rows and cz are (layers, n) host tables
        # mr_re, mr_im, mc_re, mc_im, probs, xr, xi, tmp, mct, split, n, layers,
        # has_wall, precision, rows, cz, stream
        "tn_circuit2d_grid_forward": [_P] * 10 + [_I] * 4 + [_P] * 3,
        # mr_re, mr_im, mc_re, mc_im, xr, xi, g, dmr_re, dmr_im, dmc_re, dmc_im,
        # buf_a, buf_b, split, n, layers, precision, rows, cz, stream
        "tn_circuit2d_grid_backward": [_P] * 14 + [_I] * 3 + [_P] * 3,
        # n, backward, precision -> bf16 elements of the wgmma scratch
        "tn_circuit2d_grid_split_elems": [_I] * 3,
        # a, a_elems, b, b_elems, c, probs, split, offs, strides, M, N, K, batch,
        # conj, do_split, precision, nbits, rows, cz, stream
        "tn_grid_bf16_product": [_P, _LL, _P, _LL] + [_P] * 5 + [_I] * 8 + [_P] * 3,
        # out: 2 long long, the bf16 products launched by loop (mma.sync, wgmma)
        "tn_circuit2d_grid_bf16_products": [_P],
    },
    "circuit_gates": {  # spec: the plan's records on the device, host: on the host
        # u, probs, xr, xi, tmp, spec, host, passes, has_wall, stream
        "tn_circuit_gates_forward": [_P] * 7 + [_I] * 2 + [_P],
        # u, xr, xi, g, du, buf_a, buf_b, partials, slots, spec, host, passes,
        # nslots, stream
        "tn_circuit_gates_backward": [_P] * 11 + [_I] * 2 + [_P],
        # one pass of a shard's plan: u, spec, host, src_re, src_im, dst_re, dst_im, stream
        "tn_gates_forward_pass": [_P] * 8,
        # u, spec, host, src x4, dst x4, partials, flags, stream
        "tn_gates_backward_pass": [_P] * 12 + [_I, _P],
        # partials, slots, du, nslots, stream
        "tn_gates_reduce": [_P] * 3 + [_I, _P],
        # the global-pair combines: xr, xi, tr, ti, coef, offset, count, m1, m2, b, stream
        "tn_pair_forward": [_P] * 5 + [_I] * 5 + [_P],
        # xr, xi, lr, li, their four, coef, partials, offset, count, m1, m2, b, stream
        "tn_pair_backward": [_P] * 10 + [_I] * 5 + [_P],
    },
    "stein2d": {
        # v, y, a, n, cols, stream (a as c_float: a bare Python float would
        # not be passed as a C float)
        "tn_stein2d_apply": [_P] * 2 + [ctypes.c_float] + [_I] * 2 + [_P],
        # v, y, a, n, cols, chunk, stream
        "tn_stein2d_apply_grid": [_P] * 2 + [ctypes.c_float] + [_I] * 3 + [_P],
    },
    "stein_gcorr": {
        # p0, q, st, rv, y, alpha, gamma, w1, w0, n, stream
        "tn_stein_gcorr_combine": [_P] * 5 + [ctypes.c_float] * 4 + [_I, _P],
    },
}

RESTYPES = {"tn_circuit2d_grid_split_elems": ctypes.c_longlong,
            "tn_circuit2d_scratch_bytes": ctypes.c_longlong,
            "tn_circuit2d_grid_bf16_products": None}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def launch_key(kernel: str, precision: str) -> str:
    """The ``LAUNCHES`` key of ``kernel`` at a kernel precision: the
    kernel's own name for ``highest``, ``<kernel>.<precision>`` else."""
    return kernel if precision == "highest" else f"{kernel}.{precision}"


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine "
                       "with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    out = _lib_path(name)
    if out.exists():
        log = out.with_suffix(".log")
        if log.exists():  # the ptxas report of the build that made it
            BUILD_LOGS[name] = log.read_text()
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish_build(name: str, out: Path, job) -> None:
    if job is None:
        return
    proc, tmp = job
    with span("kernels.build"):
        log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_all() -> Dict[str, Path]:
    """Compile every kernel source in parallel; returns the library paths."""
    with _lock:
        jobs = {name: _start_build(name) for name in SOURCES}
        try:
            for name, (out, job) in jobs.items():
                _finish_build(name, out, job)
        finally:
            for _, job in jobs.values():
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
        return {name: out for name, (out, _) in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, job = _start_build(name)
            _finish_build(name, out, job)
            lib = ctypes.CDLL(str(out))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = RESTYPES.get(fn, ctypes.c_int)
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
