"""``epoch_mfu`` of a host-bound cell (it moves ``epochs_per_s.host_bound``):
percent of the FP32 peak of the cell's chips that the epoch's counted work
reaches over the traced window's wall time."""


def read(run):
    if not run.peak_flops:
        return None
    return (100.0 * run.work["epoch"]["flops"] * run.epochs / run.window_s
            / (run.chips * run.peak_flops))
