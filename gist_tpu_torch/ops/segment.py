"""Edge-space ops of the GAT attention (``gist_tpu/ops/segment.py``):
SDDMM scores, the per-receiver softmax and the weighted neighbour sum,
over the padded edge list.

This is the plain GAT path: the path of graphs without a dedup layout
(every batch under ``sampler.TILES_MIN_EDGES`` edges, the full-graph
eval) and the exact reference of K4–K6 (``_xla_reference``, here
:func:`gat_attention_segment`).  Its sums and the backwards of its
gathers go through :mod:`gist_tpu_torch.ops.segment_csr` (S1 on the
card, in edge order; the plain versions on the CPU): the softmax
denominators, the weighted sum, and the score gathers by sender and by
receiver.  The per-receiver max takes no gradient and does not depend on
the order, so it stays a ``scatter_reduce``.  Padding edges (receiver
``n_nodes``) land in a sink row of the max that is cut off, since
``scatter_reduce`` raises on that index where JAX's segment ops drop it;
every sum leaves them out.
"""

from __future__ import annotations

from typing import Optional

import torch

from gist_tpu_torch.graph import Graph
from gist_tpu_torch.ops import segment_csr as csr


def _clip(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``mode="clip"`` gathers: padding receivers read row n - 1."""
    return idx.clamp(max=n - 1)


def sddmm_concat(graph: Graph, z: torch.Tensor, attn_l: torch.Tensor,
                 attn_r: torch.Tensor) -> torch.Tensor:
    """Edge scores ``(z_s . attn_l) + (z_r . attn_r)``: z (N, D) with
    attn (D,) or (D, H) -> (E,) or (E, H), before the leaky ReLU."""
    return (csr.gather_senders(graph, z @ attn_l)
            + csr.gather_receivers(graph, z @ attn_r))


def segment_softmax(graph: Graph, scores: torch.Tensor) -> torch.Tensor:
    """Softmax over each receiver's incoming edges; padding edges get
    weight 0 and a receiver without edges none (the 1e-20 floor keeps
    its 0/0 out).  The max is a constant of the softmax, so it takes no
    gradient."""
    n = graph.n_nodes
    seg = graph.receivers.long()
    shape = (n + 1,) + tuple(scores.shape[1:])
    idx = seg.view((-1,) + (1,) * (scores.dim() - 1)).expand_as(scores)
    with torch.no_grad():
        maxes = torch.full(shape, float("-inf"), dtype=scores.dtype,
                           device=scores.device)
        maxes.scatter_reduce_(0, idx, scores, reduce="amax")
        maxes = torch.where(torch.isfinite(maxes), maxes, 0.0)[:n]
    exp = torch.exp(scores - maxes[_clip(seg, n)])
    valid = (seg < n).view((-1,) + (1,) * (scores.dim() - 1))
    exp = torch.where(valid, exp, 0.0)
    sums = csr.sum_rows(exp, graph.indptr, graph.receivers)
    return exp / csr.gather_receivers(graph, sums).clamp(min=1e-20)


def segment_weighted_sum(graph: Graph, z: torch.Tensor, alpha: torch.Tensor,
                         edge_chunk: Optional[int] = None) -> torch.Tensor:
    """``h_r = sum_e alpha_e z_{send(e)}``: z (N, D) or (N, H, D), alpha
    (E,) or (E, H).  On the CPU the edges go in chunks of ~1 GiB of
    weighted messages (``edge_chunk`` when given), so a full-graph eval
    does not gather every message at once; on the card S1 reads each
    message in place."""
    return csr.weighted_sum(graph, z, alpha, edge_chunk)


def gat_attention_segment(graph: Graph, z: torch.Tensor,
                          src_score: torch.Tensor, dst_score: torch.Tensor,
                          negative_slope: float = 0.01) -> torch.Tensor:
    """The attention aggregation as the composite
    (``gist_tpu/ops/pallas_gat.py:_xla_reference``): z (N, O) with scores
    (N,), or z (N, H, O) with scores (N, H)."""
    scores = (csr.gather_senders(graph, src_score)
              + csr.gather_receivers(graph, dst_score))
    scores = torch.nn.functional.leaky_relu(scores, negative_slope)
    alpha = segment_softmax(graph, scores)
    return segment_weighted_sum(graph, z, alpha)
