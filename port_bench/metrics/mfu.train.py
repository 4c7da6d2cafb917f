"""mfu.train: model FLOPs of the window's ensemble steps, counted on the plain reference, over its wall time and the step's peak, in %. Moves member_steps_per_s."""

from benchlib import readers


def read(r: readers.Readings):
    return readers.mfu(r)
