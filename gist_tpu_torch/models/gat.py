"""Multi-head GAT with IST-capable width arithmetic
(``gist_tpu/models/gat.py``).

Heads are a leading axis of stacked parameters: per layer ``w`` is
(heads, in, out) and ``attn`` (heads, 2*out), the JAX layout, so JAX
parameters load unchanged.  ELU follows every layer, including the
last, and head outputs are averaged.  GAT has no dropout; ``apply``
takes ``train=`` and ``generator=`` only so that the IST burst drives
it like the SAGE stack.

The attention runs through K4–K6 (``ops/gat_dedup.py``) when the
backend resolves to ``dedup`` (a graph on the card with the dedup
layout pair) and through the segment composite otherwise.  As in the
JAX package, all heads share one kernel call when
``heads * ceil(out / 128) * 128 <= 1024`` and take one call per head
beyond that.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from gist_tpu_torch.graph import Graph
from gist_tpu_torch.models.common import xavier_normal_gain
from gist_tpu_torch.ops.segment import gat_attention_segment

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class GATConfig:
    in_feats: int
    n_hidden: int
    n_classes: int
    n_layers: int = 2          # total layers
    n_heads: int = 2
    num_subnet: int = 1        # hidden dims divided for IST sub-models
    # compute dtype inside apply ("float32" or "bfloat16"); logits are
    # returned fp32
    dtype: str = "float32"

    def layer_shapes(self):
        """[(in, out, heads)] per layer: in -> hidden (H heads), hidden
        -> hidden (H heads), hidden -> classes (1 head); the hidden width
        is ceil(n_hidden / num_subnet)."""
        hid = -(-self.n_hidden // self.num_subnet)
        shapes = [(self.in_feats, hid, self.n_heads)]
        for _ in range(self.n_layers - 2):
            shapes.append((hid, hid, self.n_heads))
        shapes.append((hid, self.n_classes, 1))
        return shapes

    def sub_config(self, num_subnet: int) -> "GATConfig":
        return replace(self, num_subnet=num_subnet)


def init(generator: torch.Generator, cfg: GATConfig) -> dict:
    """``w`` (heads, in, out) and ``attn`` (heads, 2*out), xavier normal
    with gain sqrt(2), drawn from ``generator`` on its device."""
    gain = float(np.sqrt(2.0))
    layers = []
    for d_in, d_out, heads in cfg.layer_shapes():
        w = torch.stack([xavier_normal_gain(generator, (d_in, d_out), gain)
                         for _ in range(heads)])
        attn = torch.stack([xavier_normal_gain(generator, (2 * d_out,), gain)
                            for _ in range(heads)])
        layers.append({"w": w, "attn": attn})
    return {"layers": layers}


def _multi_head_layer(graph: Graph, h: torch.Tensor, layer: dict,
                      negative_slope: float,
                      backend: str = "segment") -> torch.Tensor:
    """All heads: z (N, heads, out), attention per head, mean over
    heads."""
    w, attn = layer["w"], layer["attn"]
    heads, _, d_out = w.shape
    z = torch.einsum("nf,hfo->nho", h, w).contiguous()
    src = torch.einsum("nho,ho->nh", z, attn[:, :d_out])
    dst = torch.einsum("nho,ho->nh", z, attn[:, d_out:])
    if backend == "dedup":
        from gist_tpu_torch.ops.gat_dedup import (gat_attention_dedup,
                                                  gat_attention_dedup_mh)
        if heads * (-(-d_out // 128) * 128) <= 1024:
            out = gat_attention_dedup_mh(graph, z, src, dst, negative_slope)
            return out.mean(dim=1)
        outs = [gat_attention_dedup(graph, z[:, hd], src[:, hd], dst[:, hd],
                                    negative_slope)
                for hd in range(heads)]
        return torch.stack(outs).mean(dim=0)
    if backend != "segment":
        raise ValueError(f"GAT backend must be dedup or segment, not "
                         f"{backend!r}")
    out = gat_attention_segment(graph, z, src, dst, negative_slope)
    return out.mean(dim=1)


def apply(
    params: dict,
    graph: Graph,
    x: torch.Tensor,
    cfg: GATConfig,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    negative_slope: float = 0.01,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """GAT forward: ELU after every layer; fp32 logits."""
    from gist_tpu_torch.ops.spmm import resolve_gat_backend
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
    backend = resolve_gat_backend(graph, backend)
    layers = params["layers"]
    h = x
    if cfg.dtype != "float32":
        dt = _DTYPES[cfg.dtype]
        h = h.to(dt)
        layers = [{k: v.to(dt) for k, v in layer.items()} for layer in layers]
    for layer in layers:
        h = _multi_head_layer(graph, h, layer, negative_slope,
                              backend=backend)
        h = torch.nn.functional.elu(h)
    return h.float()
