"""Profiling and debugging hooks.

Counterpart of ``tensornetworks_tpu/train/profiling.py``: a
``torch.profiler`` trace in place of ``jax.profiler``, and autograd's
anomaly mode in place of ``jax_debug_nans``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace host and device activity into ``log_dir`` (nothing for None):
    ``torch.profiler`` over the CPU and, where there is one, the card,
    written as a Chrome trace (``<host>_<pid>.<time>.pt.trace.json``) when
    the block ends. Open it in Perfetto or ``chrome://tracing``."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def debug_nans(enabled: bool = True) -> Iterator[None]:
    """Autograd's anomaly mode inside the block (a backward that produces a
    NaN raises, naming the forward op), the previous mode restored after."""
    old = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enabled)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(old)


class StepTimer:
    """Wall-clock timing helper producing per-step stats for history dicts."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")
