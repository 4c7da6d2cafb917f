"""peak_mem_gib.train: the device's allocation peak over the window (reset at its start), in GiB. Moves member_steps_per_s."""

from benchlib import readers


def read(r: readers.Readings):
    return readers.peak_gib(r)
