"""Device ms per epoch that rank 0's trace puts in the collectives layer
(``parallel/comm.py``: the NCCL kernels of the state's exchanges, the
sampler's gathers and the gradient's sum)."""


def read(run):
    if run.trace is None:
        return None
    t = run.trace.layer_s.get("collectives", 0.0)
    return 1e3 * t / run.epochs if t > 0 else None
