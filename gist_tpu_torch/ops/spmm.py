"""Sparse neighborhood aggregation (SpMM): ``out[i] = sum_{(s,i) in E} x[s]``.

Two backends, as in ``gist_tpu/ops/spmm.py``:

* ``segment`` — gather source rows, ``index_add_`` over receivers;
  differentiable through autograd.  The correctness reference, and the
  path of graphs without a layout (the full-graph eval).
* ``dedup`` — the K1 kernel on the graph's dedup layout
  (:mod:`gist_tpu_torch.ops.dedup_spmm`); its plain version on CPU
  tensors.

``auto`` (the default) selects ``dedup`` for a graph on a CUDA device
that carries a dedup layout, and ``segment`` otherwise.  There is no
fallback between the two: a graph sent to ``dedup`` launches K1 or
raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from gist_tpu_torch.graph import Graph

_BACKENDS = ("segment", "dedup", "auto")
_DEFAULT_BACKEND = "auto"


def set_default_backend(name: str) -> None:
    global _DEFAULT_BACKEND
    if name not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, not {name!r}")
    _DEFAULT_BACKEND = name


def resolve_backend(graph: Optional[Graph] = None,
                    backend: Optional[str] = None) -> str:
    backend = backend or _DEFAULT_BACKEND
    if backend != "auto":
        return backend
    on_card = graph is not None and graph.senders.is_cuda
    return "dedup" if on_card and graph.dedup is not None else "segment"


def resolve_gat_backend(graph: Optional[Graph] = None,
                        backend: Optional[str] = None) -> str:
    """Backend of the GAT attention (``gist_tpu/ops/spmm.py:52``):
    ``auto`` selects ``dedup`` (K4–K6) for a graph on a CUDA device that
    carries the dedup layout pair, and ``segment`` otherwise."""
    backend = backend or _DEFAULT_BACKEND
    if backend != "auto":
        return backend
    on_card = graph is not None and graph.senders.is_cuda
    return ("dedup" if on_card and graph.dedup is not None
            and graph.dedup_t is not None else "segment")


def tiles_wanted() -> bool:
    """Should graph builders pay the host-side layout cost?  True when
    the active backend could consume it (dedup, or auto with a card)."""
    if _DEFAULT_BACKEND == "dedup":
        return True
    return _DEFAULT_BACKEND == "auto" and torch.cuda.is_available()


def spmm_segment(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """Gather + index_add aggregation over all edges at once."""
    return spmm_segment_chunked(graph, x,
                                edge_chunk=max(graph.n_edges_padded, 1))


def spmm_segment_chunked(graph: Graph, x: torch.Tensor,
                         edge_chunk: Optional[int] = None) -> torch.Tensor:
    """Memory-bounded aggregation: edge chunks of ~1 GiB of gathered
    messages each, accumulated into one output.  Padding edges
    (receiver ``n_nodes``) land in a sink row that is cut off:
    ``index_add_`` raises on out-of-range indices where the JAX
    package's ``segment_sum`` drops them."""
    if edge_chunk is None:
        f_bytes = max(int(x.shape[-1]) * x.element_size(), 1)
        edge_chunk = max(2 ** 30 // f_bytes, 65536)
    out = torch.zeros((graph.n_nodes + 1, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    for a in range(0, graph.n_edges_padded, edge_chunk):
        s = graph.senders[a:a + edge_chunk]
        r = graph.receivers[a:a + edge_chunk]
        out.index_add_(0, r, x.index_select(0, s))
    return out[:graph.n_nodes]


def aggregate(graph: Graph, x: torch.Tensor, *,
              norm: Optional[torch.Tensor] = None,
              backend: Optional[str] = None) -> torch.Tensor:
    """Aggregate neighbor features, optionally scaling rows by ``norm``."""
    if resolve_backend(graph, backend) == "dedup":
        from gist_tpu_torch.ops.dedup_spmm import spmm_dedup
        out = spmm_dedup(graph, x)
    else:
        out = spmm_segment_chunked(graph, x)
    if norm is not None:
        if norm.dim() == 1:
            norm = norm[:, None]
        out = out * norm
    return out
