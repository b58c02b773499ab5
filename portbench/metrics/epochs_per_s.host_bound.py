"""``epochs_per_s`` of a host-bound cell, whose rate follows the speed of
the host's cores and spreads several times wider than a device-bound
cell's: epochs the window completed over its wall time (host clock,
ending in a device sync), under a bound of its own."""


def read(run):
    return run.epochs / run.window_s
