"""The benchmark's frozen arithmetic: the card's peaks, the least time of
a piece of work, and the operations and bytes of one sub-model step of
each model, computed from the batch's shapes alone.

* Peaks: NVIDIA's H100 SXM data sheet (dense rates), as the port's
  ``bench/common.py`` has them: 67 TFLOP/s in fp32 outside the tensor
  cores, 3.35 TB/s of HBM.
* :func:`step_flops` counts the model's work on the real (unpadded)
  nodes and edges: the dense layers' matrix products forward and
  backward (no input gradient for layer 0, whose input takes none) and
  the sums over edges (aggregation, attention scores and weighted sums,
  forward and backward).  Elementwise work (norms, activations,
  dropout, softmax exponentials) and the optimizer are not counted;
  padding and recomputation never are.
* :func:`gemm_flops` counts the dense layers' matrix products alone, on
  the padded node count the products really run at.
* :func:`segment_sums` lists the segment sums a step needs, each with
  its least bytes: the CSR offsets, the indices (where the sum reads its
  rows through an index), the weights, the rows summed and the output,
  each once.  The list is the mathematics' and stays the same whatever
  kernel implements the sums.

numpy-free, torch-free: plain Python over integers.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
ITEM = 4   # fp32 bytes; int32 offsets and indices


def least_seconds(nbytes: float, flops: float,
                  dtype: str = "float32") -> float:
    """The least time of ``nbytes`` of traffic and ``flops`` operations at
    the card's peaks."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def sub_width(n_hidden: int, num_subnet: int) -> int:
    """A sub-model's hidden width: ceil(n_hidden / K)."""
    return -(-n_hidden // num_subnet)


def sage_dims(cfg: dict, in_feats: int, n_classes: int,
              num_subnet: int) -> list:
    """[(d_in, d_out)] of a SAGE sub-model (hidden boundaries and the
    last one split, the input not)."""
    h = sub_width(cfg["n_hidden"], num_subnet)
    dims = [in_feats] + [h] * cfg["n_layers"] + [n_classes]
    return list(zip(dims[:-1], dims[1:]))


def gat_dims(cfg: dict, in_feats: int, n_classes: int,
             num_subnet: int) -> list:
    """[(d_in, d_out, heads)] of a GAT sub-model (hidden boundaries
    split)."""
    h = sub_width(cfg["n_hidden"], num_subnet)
    dims = [(in_feats, h, cfg["n_heads"])]
    dims += [(h, h, cfg["n_heads"])] * (cfg["n_layers"] - 2)
    return dims + [(h, n_classes, 1)]


def _sage_gemm(n: int, dims: list) -> int:
    out = 0
    for i, (d_in, d_out) in enumerate(dims):
        mm = 2 * n * 2 * d_in * d_out
        out += mm * (3 if i else 2)      # forward, dW, dX past layer 0
    return out


def _gat_gemm(n: int, dims: list) -> int:
    out = 0
    for i, (d_in, d_out, heads) in enumerate(dims):
        mm = 2 * n * d_in * heads * d_out
        out += mm * (3 if i else 2)
    return out


def step_flops(model: str, dims: list, n: int, e: int) -> int:
    """Model FLOPs of one training step on ``n`` real nodes and ``e``
    real edges."""
    if model == "sage":
        sums = sum(e * d_in * (2 if i else 1)
                   for i, (d_in, _) in enumerate(dims))
        return _sage_gemm(n, dims) + sums
    if model == "gat":
        out = _gat_gemm(n, dims)
        for d_in, d_out, heads in dims:
            scores = 2 * 2 * n * heads * d_out       # z . attn, both halves
            out += 3 * scores                        # forward, dz, dattn
            out += 2 * e * heads * d_out * 3         # weighted sum, dz, dalpha
            out += 8 * e * heads                     # edge scores, softmax
        return out
    raise ValueError(model)


def gemm_flops(model: str, dims: list, n_pad: int) -> int:
    """The dense layers' matrix-product FLOPs of one step at ``n_pad``
    rows."""
    return _sage_gemm(n_pad, dims) if model == "sage" \
        else _gat_gemm(n_pad, dims)


def segment_sum_bytes(rows: int, edges: int, cols: int, heads: int = 1,
                      indexed: bool = True, weighted: bool = False,
                      src_rows: int = None) -> tuple:
    """(bytes, flops) of one segment sum of ``edges`` terms into ``rows``
    output rows of ``heads`` x ``cols`` values: offsets, indices,
    weights, the source rows (``src_rows``, default ``rows``; per-edge
    values when not ``indexed``) and the output, each once."""
    if src_rows is None:
        src_rows = rows if indexed else edges
    nbytes = ((rows + 1) * ITEM
              + (edges * ITEM if indexed else 0)
              + (edges * heads * ITEM if weighted else 0)
              + src_rows * heads * cols * ITEM
              + rows * heads * cols * ITEM)
    flops = edges * heads * cols * (2 if weighted else 1)
    return nbytes, flops


def segment_sums(model: str, dims: list, n: int, e: int) -> list:
    """(bytes, flops) of each segment sum one step needs on ``n`` real
    nodes and ``e`` real edges.  SAGE: the aggregation of every layer,
    and its transpose for every layer past the first.  GAT, per layer:
    the softmax denominators, the weighted sum and its transpose (dz),
    and in the backward the softmax's per-receiver sum and the score
    gradients summed to their senders and their receivers."""
    out = []
    if model == "sage":
        for i, (d_in, _) in enumerate(dims):
            out.append(segment_sum_bytes(n, e, d_in))
            if i:
                out.append(segment_sum_bytes(n, e, d_in))
        return out
    if model == "gat":
        for _, d_out, heads in dims:
            per_edge = segment_sum_bytes(n, e, 1, heads, indexed=False)
            by_sender = segment_sum_bytes(n, e, 1, heads, indexed=True,
                                          src_rows=e)
            weighted = segment_sum_bytes(n, e, d_out, heads, weighted=True)
            out += [per_edge, weighted,                      # forward
                    per_edge, per_edge, by_sender, weighted]  # backward
        return out
    raise ValueError(model)
