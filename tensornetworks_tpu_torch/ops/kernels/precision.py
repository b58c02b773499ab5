"""The kernels' dot precision, and the bf16 rounding that defines it.

Counterpart of ``tensornetworks_tpu/ops/pallas/precision.py`` (a copy: the
port imports nothing of the JAX package). The names are JAX's
``jax.lax.Precision`` names, case-insensitive:

- ``highest`` (the default): FP32. On the TPU six bf16 passes; here the
  kernels' FP32 FMA loops.
- ``high``: three bf16 passes, ``hi·hi + hi·lo + lo·hi`` with
  ``hi = bf16_rn(x)``, ``lo = bf16_rn(x - hi)``, FP32 accumulation.
- ``default``: one bf16 pass: both operands rounded to nearest even, the
  products exact (a product of two bf16 values is exact in FP32), FP32
  accumulation.

Circuit kernels 1, 2, 5 and 6 run ``high`` and ``default`` on the tensor
cores: ``mma.sync`` m16n8k16 bf16 (``csrc/mma_bf16.cuh``), and in kernels 5-6
the products of at least 128 tiles ``wgmma`` fed by TMA from bf16 planes split
once (``csrc/wgmma_bf16.cuh``); the Stein kernels 3-4 stay FP32 at every
setting (their time is set by bytes, and the JAX package keeps bf16 passes
off KSD gradients). The permutations and CZ signs stay exact: only the
products with the rotation operators and the adjoint's operands take the
knob.

The precision is read when a kernel plan (``CircuitPlan``, ``GridPlan``) is
built, as JAX reads it when it traces a kernel: set it *before* building a
machine, with ``set_kernel_precision("high")`` or the environment variable
``TNTPU_KERNEL_PRECISION``, read at import. A machine keeps the precision it
was built with.
"""

from __future__ import annotations

import contextlib
import os

import torch

NAMES = ("default", "high", "highest")
# The code each C entry point takes (csrc/mma_bf16.cuh: Precision).
CODES = {"highest": 0, "high": 1, "default": 2}


def precision_name(name: str) -> str:
    """The canonical name of ``name`` (case-insensitive); an unknown name
    raises ``KeyError``, as the JAX knob's table lookup does."""
    key = str(name).lower()
    if key not in NAMES:
        raise KeyError(f"unknown precision {name!r}: one of {NAMES}")
    return key


_KERNEL_PRECISION = precision_name(os.environ.get("TNTPU_KERNEL_PRECISION", "highest"))


def set_kernel_precision(precision: str) -> None:
    """Set the dot precision of kernel plans built from now on."""
    global _KERNEL_PRECISION
    _KERNEL_PRECISION = precision_name(precision)


def _kernel_precision() -> str:
    return _KERNEL_PRECISION


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bf16 value (ties to even), in x's dtype.
    The kernels see FP32 operands, so a float64 x is first cast to FP32."""
    return x.to(torch.float32).to(torch.bfloat16).to(x.dtype)


def split_bf16(x: torch.Tensor) -> tuple:
    """(hi, lo) in x's dtype: ``hi = bf16_rn(x)``, ``lo = bf16_rn(x - hi)``,
    the difference taken exactly in FP32, as the kernels split."""
    x32 = x.to(torch.float32)
    hi = x32.to(torch.bfloat16).to(torch.float32)
    lo = (x32 - hi).to(torch.bfloat16).to(torch.float32)
    return hi.to(x.dtype), lo.to(x.dtype)


@contextlib.contextmanager
def fp32_matmul():
    """torch matmuls in full FP32 inside (TF32 off for cuBLAS and cuDNN),
    whatever the matmul knob says: the plain versions are the kernels'
    yardstick, which no knob may touch. Restores both flags on exit."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
