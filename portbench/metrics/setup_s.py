"""Seconds from process start to the window's first epoch (host clock)."""


def read(run):
    return run.setup_s
