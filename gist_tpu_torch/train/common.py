"""Shared training plumbing: config, optimizer, LR schedule, results."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterable, Optional

import torch


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-2
    weight_decay: float = 5e-4
    n_epochs: int = 200
    lr_schedule: bool = False   # /10 at 50% and 75% of epochs
    seed: int = 0
    dropout_seed: int = 1234
    # IST knobs
    num_subnet: int = 1
    iter_per_site: int = 5
    split_input: bool = False
    split_output: bool = False


def reference_lr_schedule(base_lr: float, n_epochs: int, epoch: int) -> float:
    """The manual 2-step decay: lr/10 past 50%, /100 past 75% of epochs."""
    lr = base_lr
    if epoch >= int(0.5 * n_epochs):
        lr /= 10
    if epoch >= int(0.75 * n_epochs):
        lr /= 10
    return lr


def make_optimizer(params: Iterable[torch.Tensor], lr: float,
                   weight_decay: float) -> torch.optim.Adam:
    """Adam with coupled L2 (the decay is added to the gradient before
    the moment updates), betas (0.9, 0.999), eps 1e-8 — the same update
    as the JAX package's ``add_decayed_weights`` + ``adam`` chain."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def write_results(results: dict, path: Optional[str]) -> None:
    """Write a result record as JSON, stamped with the hardware."""
    if path is None:
        return
    if "hardware" not in results:
        from gist_tpu_torch.utils import hardware_tag
        results = {**results, "hardware": hardware_tag()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=2, default=float)
