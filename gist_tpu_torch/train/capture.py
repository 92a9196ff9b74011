"""One dispatch per epoch on a card: a run of training steps captured
once into a CUDA graph and replayed, the port's counterpart of the JAX
package's ``lax.scan`` over an epoch's batches
(``train_cluster_gcn(scan_batches=True)``) or over a block of epochs
(``train_full_graph(scan_epochs=k)``).

A :class:`Captured` records a callable that reads static input buffers
and writes static outputs, following PyTorch's recipe: a warm-up call
on a side stream first (it builds the kernel libraries, the optimizer's
state and cuBLAS's workspace), the state the warm-up changed put back,
then the capture.  A replay runs every kernel of the callable in one
``cudaGraphLaunch`` and calls no Python, so the kernels' ``launches``
counters count a captured launch once, at capture; :data:`stats`
counts captures and replays.

What runs inside must be capture-safe, and the port's kernels are: each
launches on ``torch.cuda.current_stream()``, allocates through PyTorch
(so into the graph's private pool), reads nothing back to the host, and
takes its grid and plan from host values that the shapes fix
(``num_tiles``, ``max_jobs``, ``max_chunks``, F).  The callers key their
captures by those shapes (:class:`GraphCache`).  A capture that fails
raises; nothing falls back to the eager loop.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Hashable, Iterable, Optional, Sequence

import torch

# captures made, their seconds (warm-up included) and replays run
stats = {"captures": 0, "capture_s": 0.0, "replays": 0}


def reset_stats() -> None:
    stats.update(captures=0, capture_s=0.0, replays=0)


class _Snapshot:
    """Copies of ``tensors``, of the optimizers' state and of the
    generators' states, put back by :meth:`restore`.  Optimizer state
    that did not exist yet (Adam builds it at its first step) is zeroed
    on restore, which is the state a fresh Adam starts from."""

    def __init__(self, tensors: Sequence[torch.Tensor],
                 optimizers: Iterable[torch.optim.Optimizer],
                 generators: Iterable[torch.Generator]):
        self.tensors = [(t, t.detach().clone()) for t in tensors]
        self.optimizers = list(optimizers)
        self.had = [{id(p): {k: v.clone() for k, v in st.items()
                             if torch.is_tensor(v)}
                     for p, st in opt.state.items()}
                    for opt in self.optimizers]
        self.generators = [(g, g.get_state()) for g in generators]

    def restore(self) -> None:
        with torch.no_grad():
            for t, saved in self.tensors:
                t.copy_(saved)
            for opt, had in zip(self.optimizers, self.had):
                for p, st in opt.state.items():
                    saved = had.get(id(p), {})
                    for k, v in st.items():
                        if not torch.is_tensor(v):
                            continue
                        if k in saved:
                            v.copy_(saved[k])
                        else:
                            v.zero_()
        for g, state in self.generators:
            g.set_state(state)


class Captured:
    """``fn`` captured into a ``torch.cuda.CUDAGraph`` on the current
    device; ``inputs`` names the static tensors it reads, which
    :meth:`replay` refills.  ``warmup`` (default ``fn``) runs once first
    on a side stream; afterwards ``state`` (tensors such as the params), the state
    of ``optimizers`` and the states of ``generators`` are put back, so
    that the warm-up leaves no trace in training.  ``generators`` are
    registered with the graph, so that each replay draws new numbers
    from them."""

    def __init__(self, fn: Callable[[], None], *,
                 inputs: Optional[dict] = None,
                 warmup: Optional[Callable[[], None]] = None,
                 state: Sequence[torch.Tensor] = (),
                 optimizers: Sequence[torch.optim.Optimizer] = (),
                 generators: Sequence[torch.Generator] = ()):
        t0 = time.time()
        self.inputs = inputs or {}
        snap = _Snapshot(state, optimizers, generators)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            (warmup or fn)()
        torch.cuda.current_stream().wait_stream(side)
        snap.restore()
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        with torch.cuda.graph(self.graph):
            fn()
        torch.cuda.synchronize()
        stats["captures"] += 1
        stats["capture_s"] += time.time() - t0

    def replay(self, values: Optional[dict] = None) -> None:
        """Copy ``values`` (name -> tensor) into the static inputs of
        the same names, then run the graph; both on the current
        stream."""
        for k, v in (values or {}).items():
            self.inputs[k].copy_(v)
        self.graph.replay()
        stats["replays"] += 1


class GraphCache:
    """The last ``size`` captures by key (a padded bucket's shapes);
    the oldest one goes, with its memory pool, when a new key comes."""

    def __init__(self, size: int = 4):
        self.size = size
        self._items: "OrderedDict[Hashable, object]" = OrderedDict()

    def get(self, key: Hashable, build: Callable[[], object]):
        if key in self._items:
            self._items.move_to_end(key)
            return self._items[key]
        while len(self._items) >= self.size:
            torch.cuda.synchronize()   # no replay of it still running
            self._items.popitem(last=False)
        item = self._items[key] = build()
        return item
