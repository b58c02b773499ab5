"""Percent of the circuit's least time (the gates' FLOPs at the FP32 peak,
or their bytes at the HBM rate, whichever is longer; counts/circuit.py)
against the device time the trace puts in the circuit layer."""


def read(run):
    return run.roofline("circuit", "circuit")
