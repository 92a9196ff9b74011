"""The cells' initial weights, made by the benchmark from the run's seed
on the device: one draw from a ``torch.Generator`` there for all of a
model's leaves, split and scaled leaf by leaf.  The distributions are the
program's initialisers' (``models/sage.py:init``: U(-s, s) with s =
1/sqrt(2 in); ``models/gat.py:init``: normal with std = sqrt(2) *
sqrt(2 / (fan_in + fan_out)) over the first and last axis of the leaf's
own shape), the numbers the benchmark's own.  Both the program and the
reference start from these tensors.  Plain PyTorch."""

from __future__ import annotations

import math

import torch


def sage_shapes(in_feats: int, n_hidden: int, n_classes: int,
                n_layers: int) -> list:
    """[(d_in, d_out)] of the full-width SAGE stack: ``n_layers`` hidden
    layers and the output layer."""
    dims = [in_feats] + [n_hidden] * n_layers + [n_classes]
    return list(zip(dims[:-1], dims[1:]))


def sage_params(generator: torch.Generator, in_feats: int, n_hidden: int,
                n_classes: int, n_layers: int) -> dict:
    """``{"layers": [{"w": (2 d_in, d_out), "b": (d_out,)}]}``, fp32 on
    the generator's device."""
    shapes = []
    for d_in, d_out in sage_shapes(in_feats, n_hidden, n_classes, n_layers):
        s = 1.0 / math.sqrt(2 * d_in)
        shapes += [("w", (2 * d_in, d_out), s), ("b", (d_out,), s)]
    u = torch.rand(sum(math.prod(sh) for _, sh, _ in shapes),
                   generator=generator, device=generator.device)
    layers, at = [], 0
    for key, sh, s in shapes:
        n = math.prod(sh)
        if key == "w":
            layers.append({})
        layers[-1][key] = u[at:at + n].view(sh) * (2 * s) - s
        at += n
    return {"layers": layers}


def gat_shapes(in_feats: int, n_hidden: int, n_classes: int, n_layers: int,
               n_heads: int) -> list:
    """[(d_in, d_out, heads)] of the full-width GAT stack."""
    shapes = [(in_feats, n_hidden, n_heads)]
    shapes += [(n_hidden, n_hidden, n_heads)] * (n_layers - 2)
    return shapes + [(n_hidden, n_classes, 1)]


def gat_params(generator: torch.Generator, in_feats: int, n_hidden: int,
               n_classes: int, n_layers: int, n_heads: int) -> dict:
    """``{"layers": [{"w": (heads, d_in, d_out), "attn": (heads,
    2 d_out)}]}``, fp32 on the generator's device."""
    leaves = []
    for d_in, d_out, heads in gat_shapes(in_feats, n_hidden, n_classes,
                                         n_layers, n_heads):
        leaves.append(("w", (heads, d_in, d_out),
                       math.sqrt(2.0) * math.sqrt(2.0 / (d_in + d_out))))
        leaves.append(("attn", (heads, 2 * d_out),
                       math.sqrt(2.0) * math.sqrt(2.0 / (4 * d_out))))
    z = torch.randn(sum(math.prod(sh) for _, sh, _ in leaves),
                    generator=generator, device=generator.device)
    layers, at = [], 0
    for key, sh, std in leaves:
        n = math.prod(sh)
        if key == "w":
            layers.append({})
        layers[-1][key] = z[at:at + n].view(sh) * std
        at += n
    return {"layers": layers}
