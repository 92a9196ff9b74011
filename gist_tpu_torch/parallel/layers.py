"""Layer building blocks of the graph-sharded models
(``gist_tpu/parallel/layers.py``).

Each runs on one rank: ``x_loc`` is its (n_loc_pad, F) row block and
``dev`` its slice of :func:`gist_tpu_torch.parallel.train.device_arrays`
(which also names the ``graph`` process group, ``dev["group"]``).
Edges live with their receiver's owner, so once the boundary senders'
rows have arrived through the ring halo every in-edge of a local node is
local; even the GAT per-receiver softmax is then a local segment op,
the cut edges' source scores riding the halo with their rows.
"""

from __future__ import annotations

import torch

from gist_tpu_torch.ops import segment_csr as csr
from gist_tpu_torch.parallel import comm
from gist_tpu_torch.parallel.graph_shard import (ShardedGraph, _segment_sum,
                                                 local_agg_ring, ring_halo)

__all__ = [
    "sharded_sum_agg", "sharded_mean_agg", "sharded_halo",
    "sharded_whole_tensor_layer_norm", "sharded_gat_attention",
]


def _inv_degree(deg: torch.Tensor) -> torch.Tensor:
    return torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                       torch.zeros_like(deg))[:, None]


def sharded_sum_agg(sg: ShardedGraph, x_loc, dev, halo_dtype=None):
    """Distributed ``out[r] = sum_{s->r} x[s]`` for one rank's rows: the
    ring halo exchange overlapped with the interior sum (K1 when the
    bundle carries the interior layouts)."""
    return local_agg_ring(sg, x_loc, dev, dev["group"], halo_dtype)


def sharded_mean_agg(sg: ShardedGraph, x_loc, dev, halo_dtype=None):
    """Mean aggregation ``(1/deg) * sum``, the SAGE layer's norm."""
    return sharded_sum_agg(sg, x_loc, dev, halo_dtype) \
        * _inv_degree(dev["in_deg"])


def sharded_halo(sg: ShardedGraph, x_loc, dev, halo_dtype=None):
    """The boundary-row exchange alone: the halo stack in ring order
    (what ``dev["bnd_s"]`` indexes)."""
    return ring_halo(sg, x_loc, dev, dev["group"], halo_dtype)


def sharded_whole_tensor_layer_norm(h, row_valid, group, *,
                                    eps: float = 1e-5):
    """``F.layer_norm(h, h.shape)`` over the whole sharded tensor, as
    the GCN normalises all nodes jointly: the moments are summed over
    ``group`` (padded rows left out by ``row_valid``, but normalised
    too; they are masked everywhere downstream)."""
    v = row_valid[:, None]
    cnt = comm.all_reduce_sum(v.sum(), group) * h.shape[-1]
    mean = comm.all_reduce_sum((h * v).sum(), group) / cnt
    var = comm.all_reduce_sum(((h - mean).square() * v).sum(), group) / cnt
    return (h - mean) * torch.rsqrt(var + eps)


def _take(a: torch.Tensor, idx: torch.Tensor, csr_of=None) -> torch.Tensor:
    """``jnp.take(..., mode="clip")``: padding indices read the last row.
    With ``csr_of``, idx's CSR (indptr, perm) from the rank's
    :class:`~gist_tpu_torch.parallel.graph_shard.EdgeCSR`, the backward
    sums each row's cotangents through S1 in that order (padding indices
    take no gradient); without it, for values that take no gradient (the
    softmax max), a plain gather."""
    if csr_of is None:
        return a.index_select(0, idx.clamp(max=a.shape[0] - 1))
    return csr.gather(a, idx, *csr_of)


def _segment_max(e: torch.Tensor, r: torch.Tensor, n: int) -> torch.Tensor:
    """Per-receiver max of (E, H) scores, -inf where a row has none."""
    out = e.new_full((n + 1,) + tuple(e.shape[1:]), float("-inf"))
    idx = r.view(-1, *([1] * (e.dim() - 1))).expand_as(e)
    return out.scatter_reduce(0, idx, e, reduce="amax")[:n]


def _lrelu(x, slope):
    return torch.nn.functional.leaky_relu(x, slope)


def gat_local_segments(aux, z_loc, src_s, dst_s, z_h, src_h, n_pad,
                       negative_slope):
    """Post-halo attention by segment ops over the interior and boundary
    edge lists (the reference math, and the exact backward of the hybrid
    path).  The softmax max is a constant of the softmax and takes no
    gradient."""
    int_s, int_r = aux["int_s"], aux["int_r"]
    bnd_s, bnd_r = aux["bnd_s"], aux["bnd_r"]
    ic, bc = aux["int_csr"], aux["bnd_csr"]
    by_r = {"int": (ic.indptr, None), "bnd": (bc.indptr, None)}
    by_s = {"int": (ic.t_indptr, ic.t_perm), "bnd": (bc.t_indptr, bc.t_perm)}
    e_int = _lrelu(_take(src_s, int_s, by_s["int"])
                   + _take(dst_s, int_r, by_r["int"]), negative_slope)
    e_bnd = _lrelu(_take(src_h, bnd_s, by_s["bnd"])
                   + _take(dst_s, bnd_r, by_r["bnd"]), negative_slope)
    with torch.no_grad():
        m = torch.maximum(_segment_max(e_int, int_r, n_pad),
                          _segment_max(e_bnd, bnd_r, n_pad))
        safe_m = torch.where(torch.isfinite(m), m, 0.0)

    def _exp(e, r):
        valid = (r < n_pad)[:, None]
        return torch.where(valid, torch.exp(e - _take(safe_m, r)), 0.0)

    x_int, x_bnd = _exp(e_int, int_r), _exp(e_bnd, bnd_r)
    den = (_segment_sum(x_int, int_r, n_pad, ic.indptr)
           + _segment_sum(x_bnd, bnd_r, n_pad, bc.indptr)).clamp(min=1e-20)

    def _wsum(x_e, r, z_src, s, part):
        alpha = x_e / _take(den, r, by_r[part])
        return _segment_sum(_take(z_src, s, by_s[part]) * alpha[:, :, None],
                            r, n_pad, by_r[part][0])

    return _wsum(x_int, int_r, z_loc, int_s, "int") \
        + _wsum(x_bnd, bnd_r, z_h, bnd_s, "bnd")


def gat_local_hybrid(aux, z_loc, src_s, dst_s, z_h, src_h, n_pad,
                     negative_slope):
    """Interior edges through K4 (its partial softmax: normalised out and
    each row's running max m_i and denominator l_i), boundary edges
    through segment partials, merged exactly:

        m = max(m_i, m_b);  l = l_i e^{m_i-m} + l_b e^{m_b-m}
        out = (out_i l_i e^{m_i-m} + acc_b e^{m_b-m}) / l

    K4 gives m and l in kernel row order; they are taken to node order
    (``_to_nodes``) before the merge.  The -1e30 sentinel of an empty
    row keeps every term finite."""
    from gist_tpu_torch.ops.gat_dedup import NEG_INF, _forward_mh, _to_nodes
    t = aux["int_dedup"]
    out_i, m_rows, l_rows = _forward_mh(t, n_pad, z_loc, src_s, dst_s,
                                        negative_slope)
    m_i, l_i = _to_nodes(t, m_rows, n_pad), _to_nodes(t, l_rows, n_pad)
    acc_i = out_i.float() * l_i[..., None]

    bnd_s, bnd_r = aux["bnd_s"], aux["bnd_r"]
    bc = aux["bnd_csr"]
    e_bnd = _lrelu(_take(src_h, bnd_s, (bc.t_indptr, bc.t_perm))
                   + _take(dst_s, bnd_r, (bc.indptr, None)), negative_slope)
    m_b = _segment_max(e_bnd, bnd_r, n_pad)
    m_b = torch.where(torch.isfinite(m_b), m_b, NEG_INF)
    valid = (bnd_r < n_pad)[:, None]
    x_b = torch.where(valid, torch.exp(
        torch.clamp(e_bnd - _take(m_b, bnd_r), max=0.0)), 0.0)
    l_b = _segment_sum(x_b, bnd_r, n_pad, bc.indptr)
    acc_b = _segment_sum(
        _take(z_h, bnd_s, (bc.t_indptr, bc.t_perm)) * x_b[:, :, None],
        bnd_r, n_pad, bc.indptr)

    m = torch.maximum(m_i, m_b)
    si = torch.exp(m_i - m)
    sb = torch.exp(m_b - m)
    l = l_i * si + l_b * sb
    out = (acc_i * si[..., None] + acc_b * sb[..., None]) \
        / l.clamp(min=1e-20)[..., None]
    return torch.where(l[..., None] > 0, out, 0.0).to(z_loc.dtype)


class _GATHybrid(torch.autograd.Function):
    """K4 forward (:func:`gat_local_hybrid`); the backward recomputes
    :func:`gat_local_segments` and differentiates it, exactly as the
    JAX package's custom VJP does (no K5/K6 here).  The halo inputs
    ``z_h`` and ``src_h`` take their cotangents, which the ring halo's
    backward sends home."""

    @staticmethod
    def forward(ctx, z_loc, src_s, dst_s, z_h, src_h, aux, n_pad, slope):
        ctx.save_for_backward(z_loc, src_s, dst_s, z_h, src_h)
        ctx.aux, ctx.n_pad, ctx.slope = aux, n_pad, slope
        return gat_local_hybrid(aux, z_loc, src_s, dst_s, z_h, src_h, n_pad,
                                slope)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            ref = gat_local_segments(ctx.aux, *leaves, ctx.n_pad, ctx.slope)
            grads = torch.autograd.grad(ref, leaves, g)
        return (*grads, None, None, None)


def sharded_gat_attention(sg: ShardedGraph, z_loc, src_s, dst_s, dev,
                          *, negative_slope: float = 0.01,
                          halo_dtype=None):
    """Multi-head GAT attention over the sharded graph for one rank's
    receiver rows: the boundary senders' ``z`` rows and source scores
    ride one ring halo as ``[z || src]``; then the local softmax over the
    interior and boundary edges, through K4 and the hybrid merge when
    the bundle carries the interior layouts.

    z_loc (n_loc_pad, H, O), src_s and dst_s (n_loc_pad, H) ->
    (n_loc_pad, H, O)."""
    n_pad, heads, d_out = z_loc.shape
    payload = torch.cat([z_loc.reshape(n_pad, heads * d_out), src_s], dim=1)
    halo = sharded_halo(sg, payload, dev, halo_dtype)
    z_h = halo[:, :heads * d_out].reshape(-1, heads, d_out)
    src_h = halo[:, heads * d_out:]
    aux = {k: dev[k] for k in ("int_s", "int_r", "bnd_s", "bnd_r",
                               "int_csr", "bnd_csr")}
    if "int_dedup" in dev:
        aux["int_dedup"] = dev["int_dedup"]
        return _GATHybrid.apply(z_loc, src_s, dst_s, z_h, src_h, aux, n_pad,
                                negative_slope)
    return gat_local_segments(aux, z_loc, src_s, dst_s, z_h, src_h, n_pad,
                              negative_slope)
