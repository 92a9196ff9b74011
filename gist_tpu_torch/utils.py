"""Shared utilities: device selection, profiling, timing, prefetch,
logging and the hardware stamp of result records
(``gist_tpu/utils.py``)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import torch


def resolve_device(device) -> torch.device:
    """The entry points' device: ``"cuda"`` unless the caller asks for
    the CPU.  A request for CUDA without a card raises; it never turns
    into a CPU run."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return d


def fold_in(seed: int, index: int) -> int:
    """A seed for stream ``index`` of ``seed`` (``jax.random.fold_in``'s
    role): the per-subnet and per-rank generators of one draw."""
    return (seed * 0x9E3779B97F4A7C15 + index * 0xBF58476D1CE4E5B9
            + 1) % (1 << 63)


def draw_seed(generator: torch.Generator) -> int:
    """One 62-bit seed drawn from ``generator`` (on its device)."""
    return int(torch.randint(0, 1 << 62, (1,), generator=generator,
                             device=generator.device).item())


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` scope over the CPU (and, with a card, CUDA)
    activities that writes a Chrome trace into ``log_dir`` on exit; a
    no-op when ``log_dir`` is None.  View it in Perfetto or
    ``chrome://tracing``."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time())}.json"))


class StepTimer:
    """Eval-excluded wall-clock accounting with a warm-up skip: the
    first ``warmup`` steps are timed but not kept."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.durs = []
        self._count = 0
        self._t0 = None

    def start(self):
        self._t0 = time.time()

    def stop(self):
        dt = time.time() - self._t0
        if self._count >= self.warmup:
            self.durs.append(dt)
        self._count += 1
        return dt

    @property
    def mean(self) -> float:
        return sum(self.durs) / len(self.durs) if self.durs else 0.0

    @property
    def total(self) -> float:
        return sum(self.durs)

    def edges_per_sec(self, edges_per_step: float) -> float:
        return edges_per_step / self.mean if self.mean else 0.0


def prefetch(iterable, depth: int = 2):
    """Run an iterator in a background thread, keeping ``depth`` items
    ready, so the host builds the next batch while the device runs the
    step.

    Unlike the JAX package's ``prefetch``, which ends the stream
    silently when the worker raises, an exception in the worker is
    raised again here, in the consumer, after the items before it."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    END = object()
    failure = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:        # handed to the consumer
            failure.append(e)
        finally:
            q.put(END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is END:
            break
        yield item
    t.join()
    if failure:
        raise failure[0]


class JsonlLogger:
    """Append-a-JSON-object-per-line logger; a no-op without a path."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)

    def log(self, **kv):
        if not self.path:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(kv, default=float) + "\n")


def hardware_tag() -> str:
    """Self-describing hardware stamp, e.g. ``nvidia-h100-80gb-hbm3-1``
    (CUDA device name and count) or ``cpu``."""
    if not torch.cuda.is_available():
        return "cpu"
    name = torch.cuda.get_device_name(0).strip().lower().replace(" ", "-")
    return f"{name}-{torch.cuda.device_count()}"
