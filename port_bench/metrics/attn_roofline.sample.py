"""attn_roofline.sample: the attention forward kernel's (B1) least time over its device time, in %. Moves images_per_s."""

from benchlib import readers


def read(r: readers.Readings):
    return readers.roofline(r, ("attention_fwd",))
