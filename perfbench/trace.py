"""The traced run's device record: ``torch.profiler`` with CUDA activity
over the window, read back as device operations on the host's wall clock
(the profiler stamps its events in nanoseconds since the epoch, as
``time.time_ns`` does, so the harness's spans line up with them)."""

from __future__ import annotations

import bisect
import collections


class DeviceTrace:
    """Starts the profiler; :meth:`stop` returns the device operations
    (kernels, copies, sets) as ``(name, start_ns, end_ns)``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> list:
        from torch.autograd import DeviceType
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in events
               if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()]
        ops.sort(key=lambda o: o[1])
        return ops


def is_kernel(name: str) -> bool:
    """A device operation that is a kernel launch, not a copy or a set."""
    return not name.startswith(("Memcpy", "Memset"))


def clip(ops: list, t0: int, t1: int) -> list:
    """``ops`` cut to the window [t0, t1] (nanoseconds)."""
    return [(n, max(a, t0), min(b, t1)) for n, a, b in ops
            if b > t0 and a < t1]


def busy_intervals(ops: list) -> list:
    """The union of the operations' intervals, as sorted disjoint
    (start, end) pairs."""
    out = []
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def idle_gaps(ops: list, t0: int, t1: int) -> list:
    """The window's stretches in which no operation ran, as (start, end)
    pairs."""
    gaps, at = [], t0
    for a, b in busy_intervals(ops):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if t1 > at:
        gaps.append((at, t1))
    return gaps


def labeller(spans: list):
    """A function from a time to the main-thread span open then (``host``
    where none is); the main thread's spans do not overlap."""
    main = sorted((a, b, name) for name, a, b, is_main in spans if is_main)
    starts = [a for a, _, _ in main]

    def label(t: int) -> str:
        i = bisect.bisect_right(starts, t) - 1
        return main[i][2] if i >= 0 and t < main[i][1] else "host"

    return label


def breakdown(ops: list, spans: list, t0: int, t1: int,
              top: int = 10) -> dict:
    """The device operations that took the most time, summed by name, and
    the idle time summed by the host span open at each gap's middle."""
    by_op = collections.Counter()
    for name, a, b in ops:
        by_op[name[:120]] += (b - a) / 1e9
    by_span = collections.Counter()
    label = labeller(spans)
    for a, b in idle_gaps(ops, t0, t1):
        by_span[label((a + b) // 2)] += (b - a) / 1e9
    return {"device_ops": [[n, s] for n, s in by_op.most_common(top)],
            "idle_gaps": [[n, s] for n, s in by_span.most_common(top)]}
