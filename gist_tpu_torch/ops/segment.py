"""Edge-space ops of the GAT attention (``gist_tpu/ops/segment.py``):
SDDMM scores, the per-receiver softmax and the weighted neighbour sum,
as gathers and scatters over the padded edge list.

This is the plain GAT path: the path of graphs without a dedup layout
(the full-graph eval) and the exact reference of K4–K6
(``_xla_reference``, here :func:`gat_attention_segment`).  Padding
edges (receiver ``n_nodes``) land in a sink row that is cut off, since
``scatter_reduce``/``index_add_`` raise on that index where JAX's
segment ops drop it.
"""

from __future__ import annotations

from typing import Optional

import torch

from gist_tpu_torch.graph import Graph


def _clip(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``mode="clip"`` gathers: padding receivers read row n - 1."""
    return idx.clamp(max=n - 1)


def sddmm_concat(graph: Graph, z: torch.Tensor, attn_l: torch.Tensor,
                 attn_r: torch.Tensor) -> torch.Tensor:
    """Edge scores ``(z_s . attn_l) + (z_r . attn_r)``: z (N, D) with
    attn (D,) or (D, H) -> (E,) or (E, H), before the leaky ReLU."""
    src_score = z @ attn_l
    dst_score = z @ attn_r
    n = graph.n_nodes
    return (src_score[_clip(graph.senders, n).long()]
            + dst_score[_clip(graph.receivers, n).long()])


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
    seg_c = _clip(seg, n)
    exp = torch.exp(scores - maxes[seg_c])
    valid = (seg < n).view((-1,) + (1,) * (scores.dim() - 1))
    exp = torch.where(valid, exp, 0.0)
    sums = torch.zeros(shape, dtype=exp.dtype, device=exp.device)
    sums = sums.index_add(0, seg, exp)[:n]
    return exp / sums[seg_c].clamp(min=1e-20)


def segment_weighted_sum(graph: Graph, z: torch.Tensor, alpha: torch.Tensor,
                         edge_chunk: Optional[int] = None) -> torch.Tensor:
    """``h_r = sum_e alpha_e z_{send(e)}``: z (N, D) or (N, H, D), alpha
    (E,) or (E, H).  Edges go in chunks of ~1 GiB of weighted messages
    (the same sum in another order), so a full-graph eval does not
    gather every message at once."""
    if edge_chunk is None:
        row_bytes = max(z[0].numel() * z.element_size(), 1)
        edge_chunk = max(2 ** 30 // row_bytes, 65536)
    out = torch.zeros((graph.n_nodes + 1,) + tuple(z.shape[1:]),
                      dtype=torch.promote_types(z.dtype, alpha.dtype),
                      device=z.device)
    for a in range(0, graph.n_edges_padded, edge_chunk):
        s = graph.senders[a:a + edge_chunk].long()
        r = graph.receivers[a:a + edge_chunk].long()
        w = alpha[a:a + edge_chunk]
        w = w.reshape(tuple(w.shape) + (1,) * (z.dim() - w.dim()))
        out = out.index_add(0, r, z[s] * w)
    return out[:graph.n_nodes]


def gat_attention_segment(graph: Graph, z: torch.Tensor,
                          src_score: torch.Tensor, dst_score: torch.Tensor,
                          negative_slope: float = 0.01) -> torch.Tensor:
    """The attention aggregation as the composite
    (``gist_tpu/ops/pallas_gat.py:_xla_reference``): z (N, O) with scores
    (N,), or z (N, H, O) with scores (N, H)."""
    n = graph.n_nodes
    scores = (src_score[_clip(graph.senders, n).long()]
              + dst_score[_clip(graph.receivers, n).long()])
    scores = torch.nn.functional.leaky_relu(scores, negative_slope)
    alpha = segment_softmax(graph, scores)
    return segment_weighted_sum(graph, z, alpha)
