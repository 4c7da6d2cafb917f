"""mfu.sample: model FLOPs of the window's denoise steps, counted on the plain reference, over its wall time and the step's peak, in %. Moves images_per_s."""

from benchlib import readers


def read(r: readers.Readings):
    return readers.mfu(r)
