"""The IST-capable SAGE stack (``gist_tpu/models/sage.py:init/apply``):
an ISTSAGELayer stack — affine-free LayerNorm, dropout between concat
and linear, LayerNorm + ReLU on every layer but the output layer.

Parameters are ``{"layers": [{"w": (2*in, out), "b": (out,)}]}`` of
tensors.  The plain GraphSAGE variant with affine LayerNorm, the
``use_pp`` first-layer precomputation and the chunked host eval wait
for later slices.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from gist_tpu_torch.graph import Graph
from gist_tpu_torch.models.common import ist_layer_dims, torch_linear_uniform
from gist_tpu_torch.models.layers import sage_layer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class SAGEConfig:
    in_feats: int
    n_hidden: int
    n_classes: int
    n_layers: int = 1          # hidden layers; stack = n_layers + 1
    dropout: float = 0.2
    use_layernorm: bool = True
    split_input: bool = False
    split_output: bool = False
    num_subnet: int = 1
    # compute dtype inside apply ("float32" or "bfloat16"); logits are
    # always returned fp32
    dtype: str = "float32"

    def layer_dims(self):
        return ist_layer_dims(
            self.in_feats, self.n_hidden, self.n_classes, self.n_layers,
            split_input=self.split_input, split_output=self.split_output,
            num_subnet=self.num_subnet)

    def sub_config(self, *, split_input: bool, split_output: bool,
                   num_subnet: int) -> "SAGEConfig":
        return replace(self, split_input=split_input,
                       split_output=split_output, num_subnet=num_subnet)


def init(generator: torch.Generator, cfg: SAGEConfig) -> dict:
    """w and b ~ U(-s, s), s = 1/sqrt(2*in), drawn from ``generator``
    (on the generator's device)."""
    layers = []
    for d_in, d_out in cfg.layer_dims():
        fan_in = 2 * d_in
        layers.append({
            "w": torch_linear_uniform(generator, (2 * d_in, d_out), fan_in),
            "b": torch_linear_uniform(generator, (d_out,), fan_in),
        })
    return {"layers": layers}


def apply(
    params: dict,
    graph: Graph,
    x: torch.Tensor,
    cfg: SAGEConfig,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Stack forward: every layer aggregates; dropout draws from
    ``generator`` in train mode."""
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
        is_last = i == n - 1
        h = sage_layer(
            graph, h, layer,
            dropout_rate=cfg.dropout if train else 0.0,
            generator=generator if train else None,
            use_layer_norm=cfg.use_layernorm and not is_last,
            activation=None if is_last else torch.relu,
            backend=backend,
        )
    return h.float()
