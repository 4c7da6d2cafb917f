"""peak_mem_gib.sample: the device's allocation peak over the window (reset at its start), in GiB. Moves images_per_s."""

from benchlib import readers


def read(r: readers.Readings):
    return readers.peak_gib(r)
