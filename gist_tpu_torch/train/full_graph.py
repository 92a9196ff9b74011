"""Full-graph training (``gist_tpu/train/full_graph.py``), the
per-epoch loop: one optimizer step on the whole graph per epoch, then an
eval of the validation and test accuracies.  Wall-clock accounting is
the JAX package's: the first 3 epochs are warm-up and the eval is
outside the epoch time; KTEPS = edges / mean epoch seconds / 1000.

``model`` is GCN by default and may be any model module of the port
with ``init(generator, cfg)`` and ``apply(params, graph, x, cfg,
train=, generator=)``, GAT among them.  The graph's layouts pick the
kernels: above ``graph.HUGE_EDGES`` edges ``prepare_graph`` builds the
chunked dedup pair (K1 once per chunk); a graph passed in with the v1
layout (``graph_from_edges(..., tiles=True, tile_mode="gather")``) runs
K3 for GCN and K7–K9 for GAT.  The epoch-scanned variant
(``scan_epochs``) is not ported.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from gist_tpu_torch.convert import params_from_jax
from gist_tpu_torch.data.container import Dataset
from gist_tpu_torch.graph import Graph, graph_from_edges
from gist_tpu_torch.models import gcn
from gist_tpu_torch.models.common import masked_accuracy, masked_cross_entropy
from gist_tpu_torch.train.common import (TrainConfig, make_optimizer,
                                         reference_lr_schedule)
from gist_tpu_torch.utils import resolve_device


def prepare_graph(ds: Dataset, tiles: Optional[bool] = None) -> Graph:
    """The dataset's graph on the host, with its dedup layouts when a
    dedup-capable backend is active (``tiles=None``) or asked for."""
    if tiles is None:
        from gist_tpu_torch.ops.spmm import tiles_wanted
        tiles = tiles_wanted()
    return graph_from_edges(ds.senders, ds.receivers, ds.n_nodes,
                            tiles=tiles)


def train_full_graph(
    ds: Dataset,
    model_cfg: gcn.GCNConfig,
    tc: TrainConfig,
    *,
    model=gcn,
    scan_epochs: int = 0,
    verbose: bool = True,
    init_params: Optional[dict] = None,
    graph: Optional[Graph] = None,
    device="cuda",
) -> dict:
    """Train ``tc.n_epochs`` epochs; returns the JAX package's result
    keys plus ``layout_build_s``, the seconds :func:`prepare_graph`
    took here (0 when the caller passes a prepared ``graph``).
    ``init_params`` (a numpy parameter tree) replaces the seeded
    initialisation."""
    if scan_epochs > 0:
        raise NotImplementedError(
            "scan_epochs fuses epochs into one XLA dispatch; the port runs "
            "the per-epoch loop")
    dev = resolve_device(device)
    t0 = time.time()
    if graph is None:
        graph = prepare_graph(ds)
    layout_build_s = time.time() - t0
    graph = graph.to(dev)
    x = torch.from_numpy(ds.features).to(dev)
    labels = torch.from_numpy(ds.labels).to(dev)
    train_mask = torch.from_numpy(ds.train_mask).to(dev)
    val_mask = torch.from_numpy(ds.val_mask).to(dev)
    test_mask = torch.from_numpy(ds.test_mask).to(dev)

    if init_params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(tc.seed),
                            model_cfg)
    else:
        params = params_from_jax(init_params, dev)
    leaves = [t.requires_grad_(True)
              for layer in params["layers"] for t in layer.values()]
    opt = make_optimizer(leaves, tc.lr, tc.weight_decay)
    generator = torch.Generator(device=dev).manual_seed(tc.dropout_seed)

    durs = []
    val_accs, test_accs, losses = [], [], []
    for epoch in range(tc.n_epochs):
        if tc.lr_schedule:
            for group in opt.param_groups:
                group["lr"] = reference_lr_schedule(tc.lr, tc.n_epochs, epoch)
        t0 = time.time()
        opt.zero_grad(set_to_none=True)
        logits = model.apply(params, graph, x, model_cfg, train=True,
                             generator=generator)
        loss = masked_cross_entropy(logits, labels, train_mask)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))   # waits for the step
        if epoch >= 3:   # warm-up epochs excluded
            durs.append(time.time() - t0)
        with torch.no_grad():
            logits = model.apply(params, graph, x, model_cfg)
            val_accs.append(float(masked_accuracy(logits, labels, val_mask)))
            test_accs.append(float(masked_accuracy(logits, labels,
                                                   test_mask)))

    mean_dur = float(np.mean(durs)) if durs else 0.0
    kteps = graph.n_edges / mean_dur / 1000 if mean_dur else 0.0
    results = {
        "dataset": ds.name,
        "final_test_acc": test_accs[-1],
        "best_val_acc": max(val_accs),
        "best_test_acc": max(test_accs),
        "val_accs": val_accs,
        "test_accs": test_accs,
        "losses": losses,
        "mean_epoch_s": mean_dur,
        "kteps": kteps,
        "train_time": mean_dur * max(len(durs), 1),
        "layout_build_s": layout_build_s,
    }
    if verbose:
        print(f"Final Test Accuracy: {test_accs[-1]:.4f}")
        print(f"Best Val Accuracy: {max(val_accs):.4f}")
        print(f"Best Test Accuracy: {max(test_accs):.4f}")
        print(f"ETputs(KTEPS) {kteps:.2f}")
    return results
