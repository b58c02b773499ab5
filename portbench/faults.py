"""Faults planted in the program under test, to show that ``correct``
catches them. Each is a context manager that patches one function of the
port for as long as it is open:

- ``unchanged``: the optimizer's guarded update returns the parameters and
  its state as they were (a step that changes nothing);
- ``half_batch``: the sampled estimator's U-statistic and REINFORCE
  surrogate see only the first half of the shots (the mean over the rest);
- ``altered_q``: the circuit's probabilities come out with their first
  entry raised by a thousandth of the largest (an answer altered where it
  is produced);
- ``altered_shots``: the two-stage sampler's shots come out with their
  last bit flipped.

Which of them a cell's path can have, each driver says (``FAULTS`` in
``drivers/<driver>.py``). The exchange between chips is not a fault these
cells can have: every cell runs on one chip.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

@contextlib.contextmanager
def _patched(owner: str, name: str, make):
    """``owner.name`` replaced by ``make(original)``; ``owner`` is a module,
    or ``module:Class``."""
    module, _, cls = owner.partition(":")
    obj = importlib.import_module(module)
    if cls:
        obj = getattr(obj, cls)
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _keep(orig):
    return lambda opt, grads, state, params, apply: (params, state)


def _half_ustat(orig):
    return lambda gram: orig(gram[:gram.shape[0] // 2, :gram.shape[0] // 2])


def _half_surrogate(orig):
    def half(gram, log_q, baseline="loo"):
        h = gram.shape[0] // 2
        return orig(gram[:h, :h], log_q[:h], baseline)
    return half


def _altered_probs(orig):
    def altered(self, params, x_condition=None):
        q = orig(self, params, x_condition)
        bump = torch.zeros_like(q)
        bump[0] = 1e-3 * q.detach().max()
        return q + bump
    return altered


def _altered_shots(orig):
    def altered(P, u_r, u_c, eps=1e-10):
        _, r, c = orig(P, u_r, u_c, eps)
        c = c ^ 1
        return r * P.shape[1] + c, r, c
    return altered


PATCHES = {
    "unchanged": [("tensornetworks_tpu_torch.engines.ksd", "guarded_update", _keep),
                  ("tensornetworks_tpu_torch.engines.sampled", "guarded_update", _keep)],
    "half_batch": [("tensornetworks_tpu_torch.engines.sampled", "ksd_ustat", _half_ustat),
                   ("tensornetworks_tpu_torch.engines.sampled", "reinforce_surrogate",
                    _half_surrogate)],
    "altered_q": [("tensornetworks_tpu_torch.models.born_quantum:QuantumBornMachine", "probs",
                   _altered_probs)],
    "altered_shots": [("tensornetworks_tpu_torch.sim.sampling", "sample_indices_2d",
                       _altered_shots)],
}


@contextlib.contextmanager
def planted(fault: str):
    if fault not in PATCHES:
        raise KeyError(f"unknown fault {fault!r}; expected one of {sorted(PATCHES)}")
    with contextlib.ExitStack() as stack:
        for owner, name, make in PATCHES[fault]:
            stack.enter_context(_patched(owner, name, make))
        yield
