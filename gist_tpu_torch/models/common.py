"""Shared model plumbing: width arithmetic, initializer, loss, metrics."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def ist_layer_dims(
    in_feats: int,
    n_hidden: int,
    n_classes: int,
    n_layers: int,
    *,
    split_input: bool = False,
    split_output: bool = False,
    num_subnet: int = 1,
) -> List[Tuple[int, int]]:
    """The reference's sub-network width arithmetic (the SAGE stack of
    ``gist_tpu/models/common.py:13``).  ``n_layers`` counts hidden
    layers; the stack has ``n_layers + 1`` weight layers.  Non-divisible
    widths get ceil(dim/K)-wide sub-layers whose trailing units are
    virtual (zero at dispatch, dropped at merge)."""
    sub_h = -(-n_hidden // num_subnet)
    dims: List[Tuple[int, int]] = []
    first_in = -(-in_feats // num_subnet) if split_input else in_feats
    if n_layers <= 1 and not split_output:
        dims.append((first_in, n_hidden))
    else:
        dims.append((first_in, sub_h))
    for i in range(n_layers - 1):
        if i == n_layers - 2 and not split_output:
            dims.append((sub_h, n_hidden))
        else:
            dims.append((sub_h, sub_h))
    dims.append((sub_h if split_output else n_hidden, n_classes))
    return dims


def torch_linear_uniform(generator: torch.Generator, shape, fan_in: int,
                         dtype=torch.float32) -> torch.Tensor:
    """uniform(-stdv, stdv), stdv = 1/sqrt(fan_in) — the SAGE layer init,
    where fan_in = 2*in."""
    stdv = 1.0 / float(np.sqrt(fan_in))
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return u * (2 * stdv) - stdv


def xavier_normal_gain(generator: torch.Generator, shape, gain: float,
                       dtype=torch.float32) -> torch.Tensor:
    """xavier_normal_ with an explicit gain: std = gain * sqrt(2 /
    (fan_in + fan_out)), fan_in = shape[0], fan_out = shape[-1] — the GAT
    init (gain sqrt(2))."""
    std = gain * float(np.sqrt(2.0 / (shape[0] + shape[-1])))
    return std * torch.randn(shape, generator=generator, dtype=dtype,
                             device=generator.device)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over masked nodes (static shapes, no boolean
    indexing): ``sum(nll * mask) / max(sum(mask), 1)``."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    m = mask.to(logits.dtype)
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    pred = logits.argmax(dim=-1)
    m = mask.to(torch.float32)
    correct = (pred == labels).to(torch.float32) * m
    return correct.sum() / m.sum().clamp(min=1.0)


def micro_f1(logits: np.ndarray, labels: np.ndarray,
             mask: np.ndarray) -> float:
    """Micro-averaged F1 of single-label predictions, which equals the
    accuracy over the mask (-1 for an empty mask).  The multitask
    variant waits for the port of multi-hot datasets."""
    mask = np.asarray(mask).astype(bool)
    if mask.sum() == 0:
        return -1.0
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    pred = np.argmax(logits, axis=-1)
    return float((pred[mask] == labels[mask]).mean())
