"""``circuit_roofline`` of a host-bound cell (it moves
``epochs_per_s.host_bound``): percent of the circuit's least time against
the device time the trace puts in the circuit layer."""


def read(run):
    return run.roofline("circuit", "circuit")
