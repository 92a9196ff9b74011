"""A frozen copy of the port's one timer (``gist_tpu_torch/bench/
timing.py``), for any number that times a kernel alone.  The runs of the
benchmark time whole rounds on the host clock and read device time from
the profiler; this module serves a later per-layer reader that needs a
kernel's time by events.

On a card (``device`` of type ``cuda``):

* :func:`kernel_ms` is device time per call: one CUDA event pair around
  n back-to-back calls, divided by n, the median of several such
  windows.  Before each window the stream sleeps long enough for the
  host to queue all n calls, so no host work falls between two
  launches.
* :func:`call_ms` is one call between two events on an idle stream:
  the wrapper's host work (checks, allocations, the ctypes call) falls
  inside it.
* :func:`span_ms` is the mean of many calls run one after another, host
  work included.

On the CPU each is the wall clock of a call (``time.perf_counter``): a
CPU run's time, never a device metric.  Imports torch and the standard
library only.
"""

from __future__ import annotations

import statistics
import time

import torch


def _cpu(device) -> bool:
    return torch.device(device).type == "cpu"


def _wall_ms(fn, reps: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def call_ms(fn, reps: int = 5, warmup: int = 2, device="cuda") -> float:
    """Median milliseconds of one call of ``fn`` between two CUDA events
    on an idle stream, its host work inside (``call_ms``); on the CPU the
    median wall clock of one call."""
    if _cpu(device):
        return _wall_ms(fn, reps, warmup)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_ms(fn, windows: int = 5, window_ms: float = 4.0,
              device="cuda") -> float:
    """Device milliseconds per call (``ms``): one CUDA event pair around
    n back-to-back calls, divided by n, the median of ``windows`` such
    windows; n makes a window last about ``window_ms``.  Before each
    window the stream sleeps for 1.5x the host time that n calls take to
    enqueue, so the host has queued every call before the first one
    starts.  On the CPU the median wall clock of one call over
    ``windows`` calls."""
    if _cpu(device):
        return _wall_ms(fn, windows, 1)
    fn()
    torch.cuda.synchronize()
    one = call_ms(fn, reps=3, warmup=0)
    n = max(1, min(2000, round(window_ms / max(one, 1e-3))))
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(enqueue_s * 1.5 * 2e9) + 1_000_000   # ~2 GHz SM clock
    times = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def span_ms(fn, iters: int, device="cuda") -> float:
    """Milliseconds per call of ``iters`` calls of ``fn`` run one after
    another after 3 warm-up calls (a first optimizer step allocates its
    state), between two CUDA events (on the CPU the wall clock): for a
    whole training step, whose host work is part of what it costs."""
    for _ in range(3):
        fn()
    if _cpu(device):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters
