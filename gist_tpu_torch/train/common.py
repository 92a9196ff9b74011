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
                   weight_decay: float, *,
                   capturable: bool = False) -> torch.optim.Adam:
    """Adam with coupled L2 (the decay is added to the gradient before
    the moment updates), betas (0.9, 0.999), eps 1e-8 — the same update
    as the JAX package's ``add_decayed_weights`` + ``adam`` chain.

    ``capturable=True`` makes the LR a 0-d float32 tensor on the params'
    device (``opt.param_groups[0]["lr"]``; write it in place to change
    it), so that a CUDA graph can replay the step with the LR of the
    moment, as the JAX package scales an lr-1 Adam's updates by the
    epoch's LR.  On a card the Adam is then capturable (its step counts
    on the device too); on the CPU, where nothing is captured, it runs
    per tensor, the form PyTorch's CPU Adam takes a tensor LR in.  The
    update is the plain Adam's."""
    params = list(params)
    if not capturable:
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    dev = params[0].device
    lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
    on_card = dev.type == "cuda"
    return torch.optim.Adam(params, lr=lr_t, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay, capturable=on_card,
                            foreach=on_card)


def seeded_init(model, cfg, seed: int, device) -> dict:
    """``model.init`` drawn from a CPU generator seeded with ``seed``,
    then moved to ``device``: the same params on every device, as the
    reference's ``PRNGKey`` draw (a CUDA generator draws other
    numbers from the same seed)."""
    p = model.init(torch.Generator().manual_seed(seed), cfg)
    return {"layers": [{k: v.to(device) for k, v in layer.items()}
                       for layer in p["layers"]]}


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


def print_reference_summary(results: dict) -> None:
    """The reference's final stdout lines (``gist_tpu/train/common.py:
    print_reference_summary``): training time, last and best val, last
    and best test, each where the results hold it."""
    if "train_time" in results:
        print(f"Training Time: {results['train_time']:.4f}", flush=True)
    if results.get("val_accs"):
        print(f"Last Val: {results['val_accs'][-1]:.4f}", flush=True)
        print(f"Best Val: {max(results['val_accs']):.4f}", flush=True)
    if results.get("test_accs"):
        print(f"Last Test: {results['test_accs'][-1]:.4f}", flush=True)
        print(f"Best Test: {max(results['test_accs']):.4f}", flush=True)
