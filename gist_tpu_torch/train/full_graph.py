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
K3 for GCN and K7–K9 for GAT.

``scan_epochs=k`` is the JAX package's epoch scan
(``_train_full_graph_scanned``): each epoch is the train step and the
eval of the val and test accuracies, run in blocks of ``k`` epochs with
one host read of the block's metrics.  On a card the epoch is captured
once into a CUDA graph (:mod:`gist_tpu_torch.train.capture`) and a
block is ``k`` replays; the epoch's LR, index and metrics live on the
device, and a capturable Adam reads the LR from a tensor that the graph
writes from the schedule.  On the CPU the same epoch runs as a plain
loop.  The first block (warm-up and capture) is left out of
``mean_epoch_s``, and the results gain ``scan_epochs``.
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
from gist_tpu_torch.train.capture import Captured
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
    opt = make_optimizer(leaves, tc.lr, tc.weight_decay,
                         capturable=scan_epochs > 0)
    generator = torch.Generator(device=dev).manual_seed(tc.dropout_seed)

    def train_step():
        opt.zero_grad(set_to_none=True)
        logits = model.apply(params, graph, x, model_cfg, train=True,
                             generator=generator)
        loss = masked_cross_entropy(logits, labels, train_mask)
        loss.backward()
        opt.step()
        return loss.detach()

    def evaluate():
        with torch.no_grad():
            logits = model.apply(params, graph, x, model_cfg)
            return (masked_accuracy(logits, labels, val_mask),
                    masked_accuracy(logits, labels, test_mask))

    if scan_epochs > 0:
        losses, val_accs, test_accs, durs = _run_scanned(
            tc, scan_epochs, opt, leaves, generator, train_step, evaluate,
            dev)
        return _results(ds, graph, durs, losses, val_accs, test_accs,
                        layout_build_s, verbose, timed_epochs=tc.n_epochs,
                        scan_epochs=scan_epochs)

    durs = []
    val_accs, test_accs, losses = [], [], []
    for epoch in range(tc.n_epochs):
        if tc.lr_schedule:
            for group in opt.param_groups:
                group["lr"] = reference_lr_schedule(tc.lr, tc.n_epochs, epoch)
        t0 = time.time()
        losses.append(float(train_step()))   # waits for the step
        if epoch >= 3:   # warm-up epochs excluded
            durs.append(time.time() - t0)
        va, ta = evaluate()
        val_accs.append(float(va))
        test_accs.append(float(ta))
    return _results(ds, graph, durs, losses, val_accs, test_accs,
                    layout_build_s, verbose, timed_epochs=max(len(durs), 1))


def _run_scanned(tc, k, opt, leaves, generator, train_step, evaluate, dev):
    """Epochs in blocks of ``k`` (the last block may be shorter), each
    epoch the train step at the schedule's LR and the eval, with the
    epoch index, the LR and the metrics on the device; one host read a
    block.  On a card one epoch is captured and a block is ``k``
    replays.  Returns (losses, val accs, test accs, seconds per epoch of
    each block after the first)."""
    n = tc.n_epochs
    lrs = torch.tensor([reference_lr_schedule(tc.lr, n, e)
                        if tc.lr_schedule else tc.lr for e in range(n)],
                       dtype=torch.float32, device=dev)
    lr = opt.param_groups[0]["lr"]
    epoch_idx = torch.zeros(1, dtype=torch.long, device=dev)
    metrics = torch.zeros((n, 3), device=dev)

    def epoch():
        lr.copy_(lrs.index_select(0, epoch_idx)[0])
        loss = train_step()
        va, ta = evaluate()
        metrics.index_copy_(0, epoch_idx, torch.stack([loss, va, ta])[None])
        epoch_idx.add_(1)

    if dev.type == "cuda":
        run = Captured(epoch, state=leaves + [lr, epoch_idx],
                       optimizers=[opt], generators=[generator]).replay
    else:
        run = epoch
    durs, rows = [], []
    while len(rows) < n:
        k_b = min(k, n - len(rows))
        t0 = time.time()
        for _ in range(k_b):
            run()
        block = metrics[len(rows):len(rows) + k_b].tolist()   # waits
        if rows:   # the first block holds the warm-up and the capture
            durs.append((time.time() - t0) / k_b)
        rows += block
    losses, val_accs, test_accs = (list(c) for c in zip(*rows))
    return losses, val_accs, test_accs, durs


def _results(ds, graph, durs, losses, val_accs, test_accs, layout_build_s,
             verbose, timed_epochs, **extra) -> dict:
    """The JAX package's result keys; ``train_time`` is the mean epoch
    times ``timed_epochs`` (the loop's timed epochs, the scan's all)."""
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
        "train_time": mean_dur * timed_epochs,
        "layout_build_s": layout_build_s,
        **extra,
    }
    if verbose:
        print(f"Final Test Accuracy: {test_accs[-1]:.4f}")
        print(f"Best Val Accuracy: {max(val_accs):.4f}")
        print(f"Best Test Accuracy: {max(test_accs):.4f}")
        print(f"ETputs(KTEPS) {kteps:.2f}")
    return results
