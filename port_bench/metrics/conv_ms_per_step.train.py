"""conv_ms_per_step.train: device milliseconds of the convolution category per ensemble step in the traced window. Moves member_steps_per_s."""

from benchlib import readers


def read(r: readers.Readings):
    return readers.category_ms_per_unit(r, "convolution")
