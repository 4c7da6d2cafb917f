"""gn_roofline.train: the GroupNorm kernels' (B3, B4) least time over their device time, in %. Moves member_steps_per_s."""

from benchlib import readers


def read(r: readers.Readings):
    return readers.roofline(r, ("group_norm_fwd", "group_norm_bwd"))
