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
  last bit flipped;
- ``exchange_self``: the exchange between chips (``parallel/comm.py``
  ``exchange``, the partner's shard for a gate on a bit that spans the
  chips) returns the rank's own buffer.

Each patches the single-card engines and the distributed sampled engine
alike. Which of them a cell's path can have, each driver says (``FAULTS``
in ``drivers/<driver>.py``): ``exchange_self`` only a cell on several
chips. The harness plants the faults it is given in every rank of a run.
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


def _altered_probs_fn(orig):
    """The distributed circuit's probabilities, the first state's entry
    raised by a thousandth of the shard's largest."""
    def make(*args, **kwargs):
        probs = orig(*args, **kwargs)

        def altered(params, *rest):
            q = probs(params, *rest)
            bump = torch.zeros_like(q)
            bump[0] = 1e-3 * q.detach().max()
            return q + bump if _first_shard() else q
        return altered
    return make


def _first_shard() -> bool:
    import torch.distributed as dist

    return dist.get_rank() == 0


def _altered_sharded_shots(orig):
    def make(*args, **kwargs):
        sample = orig(*args, **kwargs)

        def altered(P2l, u_r, u_c):
            idx, q_at = sample(P2l, u_r, u_c)
            return idx ^ 1, q_at
        return altered
    return make


def _own_buffer(orig):
    return lambda x, mesh, bit, axis="state": x


_DIST = "tensornetworks_tpu_torch.engines.distributed_sampled"

PATCHES = {
    "unchanged": [("tensornetworks_tpu_torch.engines.ksd", "guarded_update", _keep),
                  ("tensornetworks_tpu_torch.engines.sampled", "guarded_update", _keep),
                  (_DIST, "guarded_update", _keep)],
    "half_batch": [("tensornetworks_tpu_torch.engines.sampled", "ksd_ustat", _half_ustat),
                   ("tensornetworks_tpu_torch.engines.sampled", "reinforce_surrogate",
                    _half_surrogate),
                   (_DIST, "ksd_ustat", _half_ustat),
                   (_DIST, "reinforce_surrogate", _half_surrogate)],
    "altered_q": [("tensornetworks_tpu_torch.models.born_quantum:QuantumBornMachine", "probs",
                   _altered_probs),
                  ("tensornetworks_tpu_torch.parallel.distributed_ansatz",
                   "make_distributed_ansatz_probs", _altered_probs_fn),
                  (_DIST, "make_distributed_ansatz_probs", _altered_probs_fn)],
    "altered_shots": [("tensornetworks_tpu_torch.sim.sampling", "sample_indices_2d",
                       _altered_shots),
                      (_DIST, "make_distributed_two_stage_sampler", _altered_sharded_shots)],
    "exchange_self": [("tensornetworks_tpu_torch.parallel.comm", "exchange", _own_buffer),
                      ("tensornetworks_tpu_torch.parallel.shard_state", "exchange",
                       _own_buffer)],
}


@contextlib.contextmanager
def planted(fault: str):
    if fault not in PATCHES:
        raise KeyError(f"unknown fault {fault!r}; expected one of {sorted(PATCHES)}")
    with contextlib.ExitStack() as stack:
        for owner, name, make in PATCHES[fault]:
            stack.enter_context(_patched(owner, name, make))
        yield
