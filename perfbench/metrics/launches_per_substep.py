"""``launches_per_substep``: the CUDA kernels of the traced window (the
profiler's device operations other than copies and sets) over the
window's sub-model steps."""

from perfbench.trace import is_kernel


def read(rec):
    if rec.ops is None:
        return None
    return len(rec.kernels(is_kernel)) / rec.steps()
