"""Layer primitives of the SAGE stack — pure functions over tensors.

Dense weights keep the JAX package's ``(in, out)`` layout, so the
forward is ``x @ w`` and JAX parameters load unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch

from gist_tpu_torch.graph import Graph
from gist_tpu_torch.ops.spmm import aggregate


def layer_norm(h: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free per-row LayerNorm over the feature dim (the
    ISTSAGELayer's).  The affine variant of the plain GraphSAGE stack
    waits for that model's port."""
    mean = h.mean(dim=-1, keepdim=True)
    var = (h - mean).square().mean(dim=-1, keepdim=True)
    return (h - mean) * torch.rsqrt(var + eps)


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
    activation=None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """The ISTSAGELayer:
    ``ah = (A x) * (1/in_deg); h = act(LN(dropout([x || ah]) @ w + b))``.

    Dtypes promote as in the JAX package: the fp32 degree scale lifts a
    bf16 ``ah`` (and with it the concat and the product) to fp32."""
    deg = graph.in_degrees
    inv_deg = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                          torch.zeros_like(deg))[:, None]
    ah = aggregate(graph, x, backend=backend) * inv_deg
    dt = torch.promote_types(x.dtype, ah.dtype)
    h = dropout(torch.cat([x.to(dt), ah], dim=1), dropout_rate, generator)
    dt = torch.promote_types(h.dtype, params["w"].dtype)
    h = h.to(dt) @ params["w"].to(dt) + params["b"].to(dt)
    if use_layer_norm:
        h = layer_norm(h)
    if activation is not None:
        h = activation(h)
    return h
