"""``mfu``: the model FLOPs of the window's sub-model steps
(``perfbench/reference/flops.py:step_flops``, real nodes and edges) over
the window's wall seconds, as a share of the card's fp32 peak, in %."""

from perfbench.reference.flops import PEAK_FLOPS


def read(rec):
    return 100.0 * rec.flops() / rec.window_s / PEAK_FLOPS["float32"]
