"""idle_share.sample: share of the traced window with no kernel, copy or fill on the device, in %. Moves images_per_s."""

from benchlib import readers


def read(r: readers.Readings):
    return readers.idle_share(r)
