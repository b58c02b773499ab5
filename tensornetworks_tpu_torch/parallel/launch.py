"""Start the ranks of a distributed run: one process per rank.

Counterpart of the JAX package's virtual-device setup (``__graft_entry__``,
``tests/conftest.py``): JAX runs one controller over several devices; the
port runs one process per rank. ``spawn(fn, world_size, backend, device,
*args)`` starts ``world_size`` processes with ``torch.multiprocessing``'s
``spawn`` method, initialises the process group in each from a ``FileStore``
in a temporary directory (no port to pick, so parallel test workers never
race for one), runs ``fn(*args)`` on every rank and returns rank 0's result.

- ``device="cpu"`` runs ``gloo``. ``device="cuda"`` runs ``nccl`` with rank
  r on ``cuda:r``, which needs as many cards as ranks; ``backend="gloo"`` on
  CUDA puts rank r on ``cuda:(r % count)``, so that one card can hold
  several ranks, and its collectives stage through host memory
  (``parallel/comm.py``).
- The kernels are built in the parent before any rank starts
  (``ops.kernels._lib.build_all``), so the ranks only load them.
- Any rank's exception kills every rank and is raised here with the
  traceback of the rank that failed first (a peer's failure makes the
  others' collectives fail after it); the deadline ``timeout_s`` kills every rank and raises
  ``TimeoutError``, so a hung collective fails instead of waiting. Without
  a deadline the process group's collective timeout (30 minutes, or the
  deadline if that is longer) ends a hung collective.

Under ``torchrun`` the launcher has started the ranks and put the world in
the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``):
``join_launcher_world`` initialises this process's rank from it, and an
entry point then runs as this rank instead of spawning.
"""

from __future__ import annotations

import datetime
import glob
import os
import tempfile
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# The process group's collective timeout, unless the deadline is longer.
COLLECTIVE_TIMEOUT_S = 1800.0


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device) -> torch.device:
    """This rank's device for ``device``: the CPU, or the card ``spawn`` (or
    ``torchrun``'s ``LOCAL_RANK``) assigned it."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return torch.device("cuda", torch.cuda.current_device())


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str, device_type: str,
               tmp: str, args: tuple, timeout_s: float) -> None:
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(*args)
        if rank == 0:
            path = os.path.join(tmp, "result.pt")
            torch.save(out, path + ".tmp")
            os.replace(path + ".tmp", path)
        dist.barrier()
    except BaseException:
        # When this rank failed, beside its traceback: spawn reports the
        # first failure, not the peers' broken collectives that follow it.
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _first_failure(tmp: str, ctx, cause: Exception) -> Exception:
    """The exception to raise for a failed run: the traceback of the rank
    whose failure came first, else ``cause``."""
    failures = []
    for path in glob.glob(os.path.join(tmp, "error_*.txt")):
        with open(path) as f:
            stamp, tb = f.read().split("\n", 1)
        failures.append((float(stamp), int(path.rsplit("_", 1)[1].split(".")[0]), tb))
    if not failures:
        return cause
    _, rank, tb = min(failures)
    return mp.ProcessRaisedException(f"\n\n-- Rank {rank} failed first:\n{tb}", rank,
                                     ctx.processes[rank].pid)


def spawn(fn: Callable, world_size: int, backend: Optional[str] = None, device="cuda",
          *args, timeout_s: Optional[float] = None) -> Any:
    """Run ``fn(*args)`` on ``world_size`` new ranks; rank 0's result.
    ``fn`` must be importable by name (a module-level function) and its
    result picklable by ``torch.save``."""
    device = torch.device(device)
    backend = backend or default_backend(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("spawn on cuda: no CUDA device")
        if backend == "nccl" and world_size > count:
            raise ValueError(f"nccl runs one rank per card: {world_size} ranks, {count} "
                             f"card(s); run several ranks on one card with backend='gloo'")
        from ..ops.kernels import _lib

        _lib.build_all()
    collective_s = max(COLLECTIVE_TIMEOUT_S, timeout_s or 0.0)
    with tempfile.TemporaryDirectory(prefix="tn_ranks_") as tmp:
        ctx = mp.start_processes(_rank_main, nprocs=world_size, join=False,
                                 start_method="spawn",
                                 args=(fn, world_size, backend, device.type, tmp, args,
                                       collective_s))
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks of {fn.__name__} did not finish "
                                       f"within {timeout_s} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise _first_failure(tmp, ctx, e) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)


_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def join_launcher_world(backend: Optional[str] = None, device="cuda") -> bool:
    """True when this process is a rank of a world: one already initialised,
    or one a launcher (``torchrun``) put in the environment, which is then
    initialised here (this rank's card from ``LOCAL_RANK``)."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in _LAUNCHER_ENV):
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    dist.init_process_group(backend or default_backend(device))
    return True


def rank_report(device) -> dict:
    """This rank's counters: kernel launches, collective bytes, peak
    device memory (CUDA), and the transport its collectives took."""
    from ..ops.kernels import _lib
    from .comm import BYTES, transport

    device = torch.device(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {"rank": dist.get_rank(), "device": str(device), "transport": transport(device),
            "launches": dict(_lib.LAUNCHES), "comm_bytes": dict(BYTES), "peak_bytes": peak}


def gather_reports(device) -> list:
    """Every rank's ``rank_report``, in rank order, on every rank."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, rank_report(device))
    return out
