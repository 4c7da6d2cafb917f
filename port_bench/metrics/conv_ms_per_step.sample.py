"""conv_ms_per_step.sample: device milliseconds of the convolution category per denoise step in the traced window. Moves images_per_s."""

from benchlib import readers


def read(r: readers.Readings):
    return readers.category_ms_per_unit(r, "convolution")
