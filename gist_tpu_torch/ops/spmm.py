"""Sparse neighborhood aggregation (SpMM): ``out[i] = sum_{(s,i) in E} x[s]``.

Two backends, as in ``gist_tpu/ops/spmm.py``:

* ``segment`` — the path of graphs without a layout (every batch under
  ``sampler.TILES_MIN_EDGES`` edges, the full-graph trainers, the
  full-graph eval): on the card S1, one CSR row walk over the receivers
  that gathers the source rows inside the kernel and sums them in edge
  order, its gradient S1 over the transpose view
  (:mod:`gist_tpu_torch.ops.segment_csr`); on the CPU its plain version,
  gather and ``index_add_``, which is also the correctness reference.
* ``dedup`` — the kernel backend, whatever the layout: K1 on the flat
  dedup layout, K1 once per chunk on the chunked layout, K2 on the split
  layout, K3 on the v1 gather layout (``tiled``)
  (:mod:`gist_tpu_torch.ops.dedup_spmm`,
  :mod:`gist_tpu_torch.ops.split_spmm`,
  :mod:`gist_tpu_torch.ops.tiled_spmm`); their plain versions on CPU
  tensors.

``auto`` (the default) selects ``dedup`` for a graph on a CUDA device
that carries a flat, chunked or v1 layout, and ``segment`` otherwise.
There is no fallback between the two: a graph sent to ``dedup``
launches its kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from gist_tpu_torch.graph import Graph
from gist_tpu_torch.ops import segment_csr

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
    has_layout = on_card and (graph.dedup is not None
                              or graph.dedup_c is not None
                              or graph.tiled is not None)
    return "dedup" if has_layout else "segment"


def resolve_gat_backend(graph: Optional[Graph] = None,
                        backend: Optional[str] = None) -> str:
    """Backend of the GAT attention (``gist_tpu/ops/spmm.py:52``):
    ``auto`` selects ``dedup`` for a graph on a CUDA device that carries
    the flat dedup layout pair (K4–K6) or the v1 layout (K7–K9), and
    ``segment`` otherwise; the chunked attention is taken only on an
    explicit ``dedup``, as in the JAX package."""
    backend = backend or _DEFAULT_BACKEND
    if backend != "auto":
        return backend
    on_card = graph is not None and graph.senders.is_cuda
    has_layout = on_card and (graph.tiled is not None or (
        graph.dedup is not None and graph.dedup_t is not None))
    return "dedup" if has_layout else "segment"


def tiles_wanted() -> bool:
    """Should graph builders pay the host-side layout cost?  True when
    the active backend could consume it (dedup, or auto with a card)."""
    if _DEFAULT_BACKEND == "dedup":
        return True
    return _DEFAULT_BACKEND == "auto" and torch.cuda.is_available()


def spmm_segment(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """The segment aggregation over all edges at once."""
    return spmm_segment_chunked(graph, x,
                                edge_chunk=max(graph.n_edges_padded, 1))


def spmm_segment_chunked(graph: Graph, x: torch.Tensor,
                         edge_chunk: Optional[int] = None) -> torch.Tensor:
    """The segment aggregation, differentiable in x: on the card one S1
    launch over the whole graph (no message buffer, so nothing to
    bound), its gradient one over the transpose view; on the CPU the
    plain version, edge chunks of ~1 GiB of gathered messages each
    (``edge_chunk`` edges when given) accumulated into one output in
    edge order.  Padding edges (receiver ``n_nodes``) lie past
    ``indptr[-1]`` and are never read, as the JAX package's
    ``segment_sum`` drops them."""
    return segment_csr.aggregate(graph, x, edge_chunk)


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
