"""host_ms_per_step.train: host milliseconds to enqueue one ensemble step, from the benchmark's spans around each call into the step or model (no synchronise). Moves member_steps_per_s."""

from benchlib import readers


def read(r: readers.Readings):
    return readers.host_ms_per_unit(r)
