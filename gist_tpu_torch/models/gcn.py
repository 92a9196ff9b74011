"""The GCN stack (``gist_tpu/models/gcn.py``): GraphConv layers with
dropout before every layer but the first, and ReLU and the whole-tensor
LayerNorm after every layer but the last.

Parameters are ``{"layers": [{"w": (in, out), "b": (out,)}]}`` of
tensors, the JAX layout.  The IST width arithmetic (``split_input``,
``split_output``, ``num_subnet``) is the SAGE stack's.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from gist_tpu_torch.graph import Graph
from gist_tpu_torch.models.common import glorot_uniform, ist_layer_dims
from gist_tpu_torch.models.layers import (dropout, graph_conv,
                                          whole_tensor_layer_norm)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class GCNConfig:
    in_feats: int
    n_hidden: int
    n_classes: int
    n_layers: int = 1          # hidden layers; stack = n_layers + 1
    dropout: float = 0.5
    use_layernorm: bool = True
    split_input: bool = False
    split_output: bool = False
    num_subnet: int = 1
    dtype: str = "float32"     # compute dtype; logits return fp32

    def layer_dims(self):
        return ist_layer_dims(
            self.in_feats, self.n_hidden, self.n_classes, self.n_layers,
            split_input=self.split_input, split_output=self.split_output,
            num_subnet=self.num_subnet)

    def sub_config(self, *, split_input: bool, split_output: bool,
                   num_subnet: int) -> "GCNConfig":
        return replace(self, split_input=split_input,
                       split_output=split_output, num_subnet=num_subnet)


def init(generator: torch.Generator, cfg: GCNConfig) -> dict:
    """Xavier-uniform ``w`` and zero ``b`` (the GraphConv init), drawn
    from ``generator`` on its device."""
    return {"layers": [
        {"w": glorot_uniform(generator, (d_in, d_out)),
         "b": torch.zeros(d_out, device=generator.device)}
        for d_in, d_out in cfg.layer_dims()]}


def apply(
    params: dict,
    graph: Graph,
    x: torch.Tensor,
    cfg: GCNConfig,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Stack forward; dropout draws from ``generator`` in train mode."""
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
    layers = params["layers"]
    n = len(layers)
    h = x
    if cfg.dtype != "float32":
        dt = _DTYPES[cfg.dtype]
        h = h.to(dt)
        layers = [{k: v.to(dt) for k, v in layer.items()} for layer in layers]
    for i, layer in enumerate(layers):
        if i != 0 and train:
            h = dropout(h, cfg.dropout, generator)
        is_last = i == n - 1
        h = graph_conv(graph, h, layer["w"], layer["b"],
                       activation=None if is_last else torch.relu,
                       backend=backend)
        if not is_last and cfg.use_layernorm:
            h = whole_tensor_layer_norm(h)
    return h.float()
