"""``step_mfu``: the model FLOPs of the traced window's steps
(``perfbench/reference/flops.py:step_flops``) over the seconds in which
a device operation ran, as a share of the fp32 peak, in %: the steps'
share of the peak while the card is busy (``mfu`` is about this times
the busy share)."""

from perfbench.reference.flops import PEAK_FLOPS


def read(rec):
    busy = rec.busy_s()
    if not busy:
        return None
    return 100.0 * rec.flops() / busy / PEAK_FLOPS["float32"]
