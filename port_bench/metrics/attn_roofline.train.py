"""attn_roofline.train: the attention kernels' (B1, B2) least time over their device time, in %. Moves member_steps_per_s."""

from benchlib import readers


def read(r: readers.Readings):
    return readers.roofline(r, ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkv"))
