"""The work a training epoch needs, counted from the problem's shapes alone.

Each count is what the mathematics of the step needs, not what a kernel
does: the gates' own arithmetic for the circuit (``circuit.py``), and what
the engine's kind adds to it (``<kind>.py``, found by the problem's
``kind``: the Kronecker form of the Stein quadratic form for ``exact``,
the sample Gram for ``sampled``). An epoch is one circuit forward and one
adjoint backward, plus the kind's work. Nothing here depends on which
backend runs the circuit.
"""

from __future__ import annotations

import importlib
from typing import Dict

from . import circuit


def epoch_work(problem: dict) -> Dict[str, Dict[str, float]]:
    """{layer: {"flops": ..., "bytes": ...}} per epoch, and "epoch" the sum."""
    n, L, ansatz = problem["n"], problem["layers"], problem["ansatz"]
    fwd, bwd = circuit.forward(ansatz, n, L), circuit.backward(ansatz, n, L)
    out = {"circuit": {"flops": fwd["flops"] + bwd["flops"],
                       "bytes": fwd["bytes"] + bwd["bytes"]}}
    out.update(importlib.import_module(f"{__name__}.{problem['kind']}").work(problem))
    out["epoch"] = {k: sum(v[k] for v in list(out.values())) for k in ("flops", "bytes")}
    return out
