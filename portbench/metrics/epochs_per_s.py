"""Epochs the window completed over its wall time (host clock, ending in a
device sync)."""


def read(run):
    return run.epochs / run.window_s
