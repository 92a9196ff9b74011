"""Layer primitives of the SAGE, GCN and GAT stacks — pure functions
over tensors.

Dense weights keep the JAX package's ``(in, out)`` layout, so the
forward is ``x @ w`` and JAX parameters load unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch

from gist_tpu_torch.graph import Graph
from gist_tpu_torch.ops.spmm import aggregate


def whole_tensor_layer_norm(h: torch.Tensor,
                            eps: float = 1e-5) -> torch.Tensor:
    """``F.layer_norm(h, h.shape)``: the GCN normalises over the whole
    activation tensor, all nodes jointly, not per row."""
    mean = h.mean()
    var = (h - mean).square().mean()
    return (h - mean) * torch.rsqrt(var + eps)


def layer_norm(h: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """Per-row LayerNorm over the feature dim.  With ``scale``/``bias``
    it is ``nn.LayerNorm(d, elementwise_affine=True)`` (the plain
    GraphSAGE stack's); without, the affine-free variant of the
    ISTSAGELayer."""
    mean = h.mean(dim=-1, keepdim=True)
    var = (h - mean).square().mean(dim=-1, keepdim=True)
    out = (h - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return out


def dropout(h: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawn from ``generator``; identity when it is
    None (eval) or rate == 0."""
    if generator is None or rate <= 0.0:
        return h
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype,
                                                   device=h.device))


def sage_layer(
    graph: Graph,
    x: torch.Tensor,
    params: dict,
    *,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    use_layer_norm: bool = True,
    affine_ln: bool = False,
    activation=None,
    aggregate_first: bool = True,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """The SAGE layer:
    ``ah = (A x) * (1/in_deg); h = act(LN(dropout([x || ah]) @ w + b))``.

    ``affine_ln=False`` is the ISTSAGELayer; ``affine_ln=True`` scales
    and shifts the LayerNorm by ``params["ln_scale"]``/``["ln_bias"]``
    (the plain GraphSAGE layer).  ``aggregate_first=False`` skips the
    aggregation: the input is then already ``[x || ah]``, 2*in wide (the
    ``use_pp`` first layer in training).  Dtypes promote as in the JAX
    package: the fp32 degree scale lifts a bf16 ``ah`` (and with it the
    concat and the product) to fp32."""
    if aggregate_first:
        deg = graph.in_degrees
        inv_deg = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                              torch.zeros_like(deg))[:, None]
        ah = aggregate(graph, x, backend=backend) * inv_deg
        dt = torch.promote_types(x.dtype, ah.dtype)
        h = torch.cat([x.to(dt), ah], dim=1)
    else:
        h = x
    h = dropout(h, dropout_rate, generator)
    dt = torch.promote_types(h.dtype, params["w"].dtype)
    h = h.to(dt) @ params["w"].to(dt) + params["b"].to(dt)
    if use_layer_norm:
        if affine_ln:
            h = layer_norm(h, params["ln_scale"], params["ln_bias"])
        else:
            h = layer_norm(h)
    if activation is not None:
        h = activation(h)
    return h


def _rsqrt_degree(deg: torch.Tensor) -> torch.Tensor:
    return torch.where(deg > 0, torch.rsqrt(deg.clamp(min=1.0)),
                       torch.zeros_like(deg))[:, None]


def graph_conv(
    graph: Graph,
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    *,
    activation=None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """GraphConv with ``norm='both'``: ``act(D_in^-1/2 A D_out^-1/2 x w
    + b)``, degree-0 norms 0 (``gist_tpu/models/layers.py:56``).  The
    projection goes first when ``in_feats > out_feats``, so the
    aggregation runs at the narrower width.  Dtypes promote as in the
    JAX package: the fp32 norms lift a bf16 stack's aggregation (and the
    products after it) to fp32."""
    in_feats, out_feats = w.shape
    src_norm = _rsqrt_degree(graph.out_degrees)
    dst_norm = _rsqrt_degree(graph.in_degrees)
    if in_feats > out_feats:
        h = (x @ w.to(x.dtype)) * src_norm
        h = aggregate(graph, h, backend=backend) * dst_norm
    else:
        h = aggregate(graph, x * src_norm, backend=backend) * dst_norm
        h = h @ w.to(h.dtype)
    if b is not None:
        h = h + b
    if activation is not None:
        h = activation(h)
    return h


def gat_layer(graph: Graph, x: torch.Tensor, params: dict, *,
              negative_slope: float = 0.01) -> torch.Tensor:
    """Single-head GAT layer (``gist_tpu/models/layers.py:gat_layer``):
    ``z = x @ w; e = leaky_relu(a . [z_s || z_r]); alpha = softmax_r(e);
    h_r = sum alpha z_s``, as SDDMM, segment softmax and weighted sum.
    ``params`` holds ``w`` (in, out) and ``attn`` (2*out,): its first
    half dots z_src, its second z_dst."""
    from gist_tpu_torch.ops.segment import (sddmm_concat, segment_softmax,
                                            segment_weighted_sum)
    w, attn = params["w"], params["attn"]
    out_dim = w.shape[1]
    z = x @ w
    scores = sddmm_concat(graph, z, attn[:out_dim], attn[out_dim:])
    scores = torch.nn.functional.leaky_relu(scores, negative_slope)
    alpha = segment_softmax(graph, scores)
    return segment_weighted_sum(graph, z, alpha)
