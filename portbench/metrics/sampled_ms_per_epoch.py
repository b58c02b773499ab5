"""Device ms per epoch of the sampled estimator layer: the shots, the
scores, the Gram, the U-statistic and the REINFORCE surrogate."""


def read(run):
    if run.trace is None or run.problem["kind"] != "sampled":
        return None
    t = run.trace.layer_s.get("sampled estimator", 0.0)
    return 1e3 * t / run.epochs if t > 0 else None
