"""Cluster-GCN training on one device (``gist_tpu/train/cluster.py``),
per-batch path: one optimizer step per cluster batch, full-graph eval
every ``eval_every`` epochs, wall clock excluding eval.  The batches
come through ``prefetch``, so the host builds the next batch while the
device runs the step.  A multitask dataset (``labels_multi`` set)
trains with the sigmoid BCE on its multi-hot labels and evaluates the
threshold micro-F1; ``use_pp`` hands the model precomputed first-layer
features (``ClusterSampler(use_pp=True)``; pass a config with
``use_pp=True`` too, so the model skips that aggregation).

``scan_batches=True`` is the JAX package's epoch scan: each epoch's
``len(sampler)`` batches come from one :class:`_RoundCollector` round
in ids form, are re-padded to one bucket and stacked on the host
(:func:`~gist_tpu_torch.sampler.stack_batches`; a worker thread builds
the next epoch's stack while the device trains), and their features,
labels and masks are gathered from ``sampler.tables()`` on the device.
On a card the epoch's steps (forward, loss, backward and Adam for every
batch, each reading its slice of the stacked buffers) are captured once
per padded bucket into a CUDA graph (:mod:`gist_tpu_torch.train.
capture`), and each epoch is one copy of the stack into the graph's
static buffers and one replay; the host reads the epoch's losses once.
On the CPU the same stacked epoch runs as a loop over its slices."""

from __future__ import annotations

import time
from typing import Optional

import torch

from gist_tpu_torch.convert import params_from_jax
from gist_tpu_torch.data.container import Dataset
from gist_tpu_torch.graph import graph_from_edges
from gist_tpu_torch.models import sage
from gist_tpu_torch.models.common import (masked_accuracy,
                                          masked_bce_multitask,
                                          masked_cross_entropy, micro_f1)
from gist_tpu_torch.sampler import ClusterSampler, stack_batches
from gist_tpu_torch.train.capture import Captured, GraphCache
from gist_tpu_torch.train.common import TrainConfig, make_optimizer
from gist_tpu_torch.train.ist_cluster import _RoundCollector
from gist_tpu_torch.utils import prefetch, resolve_device


def train_cluster_gcn(
    ds: Dataset,
    model_cfg: sage.SAGEConfig,
    tc: TrainConfig,
    *,
    psize: int = 1500,
    batch_size: int = 20,
    use_pp: bool = False,
    use_f1: bool = False,
    normalize: bool = False,
    cache_dir: Optional[str] = None,
    model=sage,
    eval_every: int = 1,
    eval_cpu: bool = False,
    scan_batches: bool = False,
    init_params: Optional[dict] = None,
    device="cuda",
    verbose: bool = True,
) -> dict:
    """``init_params`` (a numpy parameter tree) replaces the seeded
    initialisation; ``eval_cpu`` evaluates the full graph on the CPU."""
    dev = resolve_device(device)
    eval_dev = torch.device("cpu") if eval_cpu else dev
    if normalize:
        ds.normalize_features()
    multitask = ds.labels_multi is not None
    train_loss = masked_bce_multitask if multitask else masked_cross_entropy
    sampler = ClusterSampler(ds, psize, batch_size, use_pp=use_pp,
                             cache_dir=cache_dir, seed=tc.seed)
    full_graph = graph_from_edges(ds.senders, ds.receivers,
                                  ds.n_nodes).to(eval_dev)
    fx = torch.from_numpy(ds.features).to(eval_dev)
    flabels = torch.from_numpy(ds.labels).to(eval_dev)
    val_mask = torch.from_numpy(ds.val_mask).to(eval_dev)
    test_mask = torch.from_numpy(ds.test_mask).to(eval_dev)

    if init_params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(tc.seed),
                            model_cfg)
    else:
        params = params_from_jax(init_params, dev)
    leaves = [t.requires_grad_(True)
              for layer in params["layers"] for t in layer.values()]
    # the scanned epoch's Adam steps inside a CUDA graph: capturable
    opt = make_optimizer(leaves, tc.lr, tc.weight_decay,
                         capturable=scan_batches)
    generator = torch.Generator(device=dev).manual_seed(tc.dropout_seed)

    def train_step(graph, feats, labels, mask):
        opt.zero_grad(set_to_none=True)
        logits = model.apply(params, graph, feats, model_cfg, train=True,
                             generator=generator)
        loss = train_loss(logits, labels, mask)
        loss.backward()
        opt.step()
        return loss.detach()

    if scan_batches:
        collector = _RoundCollector(sampler, len(sampler), ids_only=True)
        tables = sampler.tables(dev)
        captures = GraphCache()

        def run_steps(views, out):
            """One step per (graph, node ids) view; losses into out."""
            for i, (graph, ids) in enumerate(views):
                out[i] = train_step(graph, *(t.index_select(0, ids)
                                             for t in tables))

        def capture(stacked):
            bufs = {k: v.to(dev) for k, v in stacked.tensors.items()}
            views = stacked.views(bufs)
            out = torch.zeros(len(views), device=dev)
            run = Captured(lambda: run_steps(views, out), inputs=bufs,
                           warmup=lambda: run_steps(views[:1], out),
                           state=leaves, optimizers=[opt],
                           generators=[generator])
            return out, run

        def stacked_epochs():
            for _ in range(tc.n_epochs):
                batches = collector.collect()
                yield (stack_batches(batches),
                       sum(b.n_real_edges for b in batches))

        # the host builds the next epoch's stack while the card trains
        epochs = prefetch(stacked_epochs(), depth=1)

        def run_epoch_scanned():
            """(step losses, real edges) of one epoch of stacked steps."""
            stacked, e_real = next(epochs)
            if dev.type != "cuda":
                out = torch.zeros(len(stacked.tensors["node_ids"]))
                run_steps(stacked.views(), out)
                return out, e_real
            out, run = captures.get(stacked.key, lambda: capture(stacked))
            run.replay(stacked.tensors)
            return out, e_real

    def evaluate():
        with torch.no_grad():
            p = {"layers": [{k: v.detach().to(eval_dev)
                             for k, v in layer.items()}
                            for layer in params["layers"]]}
            # the eval never takes the use_pp skip (train mode only)
            logits = model.apply(p, full_graph, fx, model_cfg)
        if multitask:
            l = logits.cpu().numpy()
            return (micro_f1(l, ds.labels_multi, ds.val_mask,
                             multitask=True),
                    micro_f1(l, ds.labels_multi, ds.test_mask,
                             multitask=True))
        if use_f1:
            l = logits.cpu().numpy()
            return (micro_f1(l, ds.labels, ds.val_mask),
                    micro_f1(l, ds.labels, ds.test_mask))
        return (float(masked_accuracy(logits, flabels, val_mask)),
                float(masked_accuracy(logits, flabels, test_mask)))

    total_time = 0.0
    total_edges = 0
    epoch_times, epoch_edges = [], []
    val_accs, test_accs, losses = [], [], []
    for epoch in range(tc.n_epochs):
        t0 = time.time()
        if scan_batches:
            step_losses, e_real = run_epoch_scanned()
            total_edges += e_real
        else:
            step_losses = []
            for batch in prefetch(sampler):
                batch = batch.to(dev)
                step_losses.append(train_step(
                    batch.graph, batch.features, batch.labels,
                    batch.train_mask))
                total_edges += batch.n_real_edges
            step_losses = torch.stack(step_losses) if step_losses \
                else torch.zeros(0)
        epoch_loss = float(step_losses.sum())   # one host read an epoch
        dt = time.time() - t0  # eval excluded
        total_time += dt
        epoch_times.append(dt)
        epoch_edges.append(total_edges - sum(epoch_edges))
        evaluated = (epoch + 1) % eval_every == 0 or epoch == tc.n_epochs - 1
        if evaluated:
            va, ta = evaluate()
            val_accs.append(va)
            test_accs.append(ta)
        losses.append(epoch_loss / max(len(step_losses), 1))
        if verbose:
            val_s = f"val {val_accs[-1]:.4f}" if evaluated else \
                f"epoch_s {dt:.2f}"
            print(f"Epoch {epoch}: loss {losses[-1]:.4f} {val_s}",
                  flush=True)

    # steady state excludes epoch 0 (warm-up and kernel build)
    steady_t = sum(epoch_times[1:])
    steady_e = sum(epoch_edges[1:])
    results = {
        "dataset": ds.name,
        "train_time": total_time,
        "edges_per_sec": total_edges / total_time if total_time else 0.0,
        "steady_epoch_s": steady_t / max(len(epoch_times) - 1, 1),
        "steady_edges_per_sec": steady_e / steady_t if steady_t else 0.0,
        "last_val": val_accs[-1], "best_val": max(val_accs),
        "last_test": test_accs[-1], "best_test": max(test_accs),
        "val_accs": val_accs, "test_accs": test_accs, "losses": losses,
    }
    if verbose:
        print(f"Training Time: {total_time:.4f}", flush=True)
        print(f"Last Val: {val_accs[-1]:.4f}", flush=True)
        print(f"Best Val: {max(val_accs):.4f}", flush=True)
    return results
