"""Durable save and restore of parameters, optimizer state and best
snapshots.

Counterpart of ``tensornetworks_tpu/train/checkpoint.py``, with
``torch.save``/``torch.load(weights_only=True)`` in place of Orbax: a
checkpoint is one file holding a nested dict of CPU tensors (and plain
numbers or strings), written to ``path + ".tmp"`` and moved into place with
``os.replace``, so a killed writer never leaves a torn file. The format is
the port's own; neither package reads the other's checkpoints.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch


def _to_cpu(state: Any) -> Any:
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    if isinstance(state, dict):
        return {k: _to_cpu(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_cpu(v) for v in state)
    return state


def save_checkpoint(path: str, state: Any) -> str:
    """Write ``state`` (tensors, possibly nested in dicts, lists and tuples)
    atomically to ``path``; returns its absolute path."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)
    return path


def _match(saved: Any, target: Any, where: str) -> Any:
    """``saved`` checked against ``target`` (same keys, shapes and dtypes),
    each tensor moved to its target's device."""
    if isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"checkpoint entry {where} is not a tensor")
        if saved.shape != target.shape or saved.dtype != target.dtype:
            raise ValueError(f"checkpoint entry {where} is {tuple(saved.shape)} {saved.dtype}, "
                             f"target {tuple(target.shape)} {target.dtype}")
        return saved.to(target.device)
    if isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            got = sorted(saved) if isinstance(saved, dict) else type(saved).__name__
            raise ValueError(f"checkpoint entry {where} has keys {got}, target {sorted(target)}")
        return {k: _match(saved[k], target[k], f"{where}[{k!r}]") for k in target}
    if isinstance(target, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(target):
            raise ValueError(f"checkpoint entry {where} does not match the target's length")
        return type(target)(_match(s, t, f"{where}[{i}]")
                            for i, (s, t) in enumerate(zip(saved, target)))
    return saved


def load_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """Read a checkpoint written by ``save_checkpoint`` (tensors on the CPU).
    With ``target`` (the same structure of tensors), require the same keys,
    shapes and dtypes, and move each tensor to its target's device."""
    state = torch.load(os.path.abspath(path), weights_only=True)
    return state if target is None else _match(state, target, "checkpoint")


def training_bundle(params, opt_state=None, best_params=None, best_tvd=None,
                    epoch=None) -> dict:
    """The engines' checkpoint layout (the JAX package's keys)."""
    bundle = {"params": params}
    if opt_state is not None:
        bundle["opt_state"] = opt_state
    if best_params is not None:
        bundle["best_params"] = best_params
    if best_tvd is not None:
        bundle["best_tvd"] = best_tvd
    if epoch is not None:
        bundle["epoch"] = epoch
    return bundle
