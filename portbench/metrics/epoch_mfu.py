"""Percent of the FP32 peak that the epoch's counted work (the circuit's
gates and the Stein form or the sample Gram; counts/) reaches over the
traced window's wall time."""


def read(run):
    if not run.peak_flops:
        return None
    return 100.0 * run.work["epoch"]["flops"] * run.epochs / run.window_s / run.peak_flops
