"""The reference's side of ``correct``: follow the program's first training
steps in float64 from the same inputs, and hold the program's readings
against them.

The loss of a step, and its cotangent dL/dq, are the kind's:
``reference/<kind>.py`` holds a ``Loss`` for each engine kind (``exact``:
the Stein quadratic form; ``sampled``: the U-statistic on the program's
shots), found by the problem's ``kind``; what follows is shared.

The program hands over what it reported or left (its losses and gradient
norms per step, its parameters after the steps, its shots and the states
of the generator that drew their uniforms, its q at the end of the
window: one array, or the blocks of a cell on D cards in order); the
reference works everything else out again from the problem: the circuit,
the network's scores, the Stein form or the sampled Gram, the gradient,
the optimizer's steps and the draws. The state is held in as many blocks
as ``devices`` names (``circuit.py``); the per-shot work runs on the
first.

Numbers (each a gap, the larger the worse):

- ``loss_rel``: the largest |loss_p - loss_r| / |loss_r| over the steps;
- ``grad_rel``: the same for the gradient's global norm;
- ``step_rel``: the parameter change after the steps, by the worst leaf
  (one leaf per layer and angle): | |d_p| - |d_r| | over the larger of
  |d_r| and the median leaf's |d_r|; leaves whose first reference gradient
  is under a thousandth of the median leaf's move by round-off alone under
  Adam and are left out;
- ``q_rel``: max |q_p - q_r| / max q_r at the end-of-window parameters;
- ``q_l1``: sum |q_p - q_r| / sum q_r there, the circuit's error over all
  states (steady from seed to seed, where the largest entry's is not);
- and whatever the kind's ``Loss.numbers`` adds (``sampled``:
  ``shots_mismatch``, the shots over the steps that differ from the
  reference's draws on the same uniforms).
"""

from __future__ import annotations

import importlib
from typing import Dict

import numpy as np
import torch

from .circuit import Circuit
from .network import Network
from .optim import Adam


def _leaf_norms(v: np.ndarray, layers: int, n: int) -> np.ndarray:
    """Norms of v (L*n*3,) per (layer, angle) leaf."""
    return np.sqrt((v.reshape(layers, n, 3) ** 2).sum(axis=1)).reshape(-1)


def _rel(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-300)


def follow(problem: dict, record: dict, devices) -> Dict[str, float]:
    """The numbers of one run (see the module's docstring) with the state
    in one block a device of ``devices`` (or one device). The loss of a
    step is the problem's kind's: ``reference/<kind>.py`` ``Loss``."""
    n, L = problem["n"], problem["layers"]
    circ = Circuit(problem["ansatz"], n, L, problem["edges"], devices)
    device = circ.devices[0]
    net = Network(problem["parents"], problem["cpts"], n, problem["observed"], device)
    loss_of = importlib.import_module(f"{__package__}.{problem['kind']}").Loss(
        problem, record, net, device)
    steps = len(record["losses"])
    opt = Adam(problem["lr"], steps, clip=problem["clip"])
    theta = np.asarray(problem["theta0"], dtype=np.float64)
    losses, norms, thetas = [], [], [theta]
    g0 = None
    for k in range(steps):
        psi = circ.state(theta)
        q = [x.real ** 2 + x.imag ** 2 for x in psi]
        loss, gq = loss_of(k, q)
        del q
        losses.append(loss)
        g = circ.grad(theta, gq, psi)
        del psi, gq
        norms.append(float(np.sqrt((g * g).sum())))
        if g0 is None:
            g0 = g
        theta = opt.step(theta, g)
        thetas.append(theta)
    out = {
        "loss_rel": max(_rel(p, r) for p, r in zip(record["losses"], losses)),
        "grad_rel": max(_rel(p, r) for p, r in zip(record["grad_norms"], norms)),
    }
    d_r = _leaf_norms(thetas[record["after_steps"]] - thetas[0], L, n)
    d_p = _leaf_norms(np.asarray(record["theta_after"], np.float64) - thetas[0], L, n)
    g_leaf = _leaf_norms(g0, L, n)
    keep = g_leaf >= 1e-3 * np.median(g_leaf)
    scale = np.maximum(d_r, np.median(d_r[keep]))
    out["step_rel"] = float((np.abs(d_p - d_r) / scale)[keep].max())
    out.update(loss_of.numbers())
    del loss_of
    q_ref = circ.probs(record["theta_end"])
    q_end = record["q_end"]
    q_end = list(q_end) if isinstance(q_end, (list, tuple)) else [q_end]
    if len(q_end) != len(q_ref) or any(len(p) != len(r) for p, r in zip(q_end, q_ref)):
        raise ValueError("the program's q does not come in the reference's blocks")
    parts = []
    for r in q_ref:
        p = torch.as_tensor(q_end.pop(0), device=r.device).to(torch.float64)
        d = (p - r).abs()
        parts.append(torch.stack([d.max(), r.max(), d.sum(), r.sum()]).cpu())
        del p, d
    dmax, rmax, dsum, rsum = torch.stack(parts).T
    out["q_rel"] = float(dmax.max() / rmax.max())
    out["q_l1"] = float(dsum.sum() / rsum.sum())
    return out
