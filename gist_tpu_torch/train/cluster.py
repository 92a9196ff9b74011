"""Cluster-GCN training on one device (``gist_tpu/train/cluster.py``),
per-batch path: one optimizer step per cluster batch, full-graph eval
every ``eval_every`` epochs, wall clock excluding eval.  The batches
come through ``prefetch``, so the host builds the next batch while the
device runs the step.  The epoch-scanned variant (``scan_batches``) is
not ported."""

from __future__ import annotations

import time
from typing import Optional

import torch

from gist_tpu_torch.convert import params_from_jax
from gist_tpu_torch.data.container import Dataset
from gist_tpu_torch.graph import graph_from_edges
from gist_tpu_torch.models import sage
from gist_tpu_torch.models.common import (masked_accuracy,
                                          masked_cross_entropy, micro_f1)
from gist_tpu_torch.sampler import ClusterSampler
from gist_tpu_torch.train.common import TrainConfig, make_optimizer
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
    eval_every: int = 1,
    eval_cpu: bool = False,
    scan_batches: bool = False,
    init_params: Optional[dict] = None,
    device="cuda",
    verbose: bool = True,
) -> dict:
    """``init_params`` (a numpy parameter tree) replaces the seeded
    initialisation; ``eval_cpu`` evaluates the full graph on the CPU."""
    if use_pp:
        raise NotImplementedError(
            "the use_pp precomputation waits for the slice that ports the "
            "plain GraphSAGE stack")
    if scan_batches:
        raise NotImplementedError(
            "scan_batches fuses an epoch into one XLA dispatch; the port "
            "runs the per-batch loop")
    dev = resolve_device(device)
    eval_dev = torch.device("cpu") if eval_cpu else dev
    if normalize:
        ds.normalize_features()
    sampler = ClusterSampler(ds, psize, batch_size, cache_dir=cache_dir,
                             seed=tc.seed)
    full_graph = graph_from_edges(ds.senders, ds.receivers,
                                  ds.n_nodes).to(eval_dev)
    fx = torch.from_numpy(ds.features).to(eval_dev)
    flabels = torch.from_numpy(ds.labels).to(eval_dev)
    val_mask = torch.from_numpy(ds.val_mask).to(eval_dev)
    test_mask = torch.from_numpy(ds.test_mask).to(eval_dev)

    if init_params is None:
        params = sage.init(torch.Generator(device=dev).manual_seed(tc.seed),
                           model_cfg)
    else:
        params = params_from_jax(init_params, dev)
    leaves = [t.requires_grad_(True)
              for layer in params["layers"] for t in layer.values()]
    opt = make_optimizer(leaves, tc.lr, tc.weight_decay)
    generator = torch.Generator(device=dev).manual_seed(tc.dropout_seed)

    def evaluate():
        with torch.no_grad():
            p = {"layers": [{k: v.detach().to(eval_dev)
                             for k, v in layer.items()}
                            for layer in params["layers"]]}
            logits = sage.apply(p, full_graph, fx, model_cfg)
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
        step_losses = []
        for batch in prefetch(sampler):
            batch = batch.to(dev)
            opt.zero_grad(set_to_none=True)
            logits = sage.apply(params, batch.graph, batch.features,
                                model_cfg, train=True, generator=generator)
            loss = masked_cross_entropy(logits, batch.labels,
                                        batch.train_mask)
            loss.backward()
            opt.step()
            step_losses.append(loss.detach())
            total_edges += batch.n_real_edges
        epoch_loss = float(torch.stack(step_losses).sum()) if step_losses \
            else 0.0
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
