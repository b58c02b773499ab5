"""``sampled_ms_per_epoch`` of a host-bound cell (it moves
``epochs_per_s.host_bound``): device ms per epoch of the sampled
estimator layer."""


def read(run):
    if run.trace is None or run.problem["kind"] != "sampled":
        return None
    t = run.trace.layer_s.get("sampled estimator", 0.0)
    return 1e3 * t / run.epochs if t > 0 else None
