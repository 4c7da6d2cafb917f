"""idle_share.train: share of the traced window with no kernel, copy or fill on the device, in %. Moves member_steps_per_s."""

from benchlib import readers


def read(r: readers.Readings):
    return readers.idle_share(r)
