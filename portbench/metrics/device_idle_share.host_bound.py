"""``device_idle_share`` of a host-bound cell (it moves
``epochs_per_s.host_bound``): percent of the traced window's wall time in
which no device operation ran."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or run.trace.events == 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
