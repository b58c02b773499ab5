"""Percent of the exact Stein quadratic form's least time
(counts/exact.py) against the device time of the stein operator layer."""


def read(run):
    return run.roofline("stein operator", "stein")
