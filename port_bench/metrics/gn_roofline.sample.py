"""gn_roofline.sample: the GroupNorm forward kernel's (B3) least time over its device time, in %. Moves images_per_s."""

from benchlib import readers


def read(r: readers.Readings):
    return readers.roofline(r, ("group_norm_fwd",))
