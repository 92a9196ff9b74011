"""Distributed IST + Cluster-GCN sampling
(``gist_tpu/train/ist_cluster.py``) on one device.

Each round collects ``iter_per_site`` cluster batches on the host (the
next round's collection runs in a worker thread while the card trains),
draws the round's boundary partitions, and then, for each subnet s in
turn: dispatch, a fresh Adam and one step per batch
(``build_local_burst_single``).  The trained shards are stacked and
merged into the full-width model, which is evaluated on the full graph
at the ``len(sampler)`` step cadence of the JAX trainer.

With ``mesh`` (a ``subnet`` mesh of K ranks,
:func:`gist_tpu_torch.ist.distributed.make_subnet_mesh`) the K subnets
train side by side, one a rank, and one all_gather of their shards
feeds the merge (:func:`gist_tpu_torch.ist.distributed.build_ist_round`),
as in the JAX trainer; every rank runs the sampler and the partitions,
rank 0 evaluates and saves, and every rank returns rank 0's results.
The subnets' steps are independent and subnet s draws its dropout from
the round seed's stream s in both modes, so the loop and the mesh
compute the same round.

``lsgd=True`` is the local-SGD baseline, run the same way as a loop on
one device: no boundary is split, so each of the K workers trains a
copy of the full model on its own ``iter_per_site`` batches of the
round's ``K * iter_per_site``, and the merge averages every leaf.  Its
``edges_per_sec`` keeps the JAX trainer's formula, which counts the
round's ``K * iter_per_site`` batches K times.

With ``checkpoint_dir`` every eval round saves the params, the round,
the states of the partition and dropout generators and the eval
cadence's counters (:mod:`gist_tpu_torch.train.checkpoint`); a rerun
with the same arguments resumes after the newest round, replaying the
batch stream the finished rounds consumed.  The JAX trainer restarts
its eval cadence on resume; the port continues it, so a resumed run
evaluates at the rounds the uninterrupted run did.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import torch

from gist_tpu_torch.convert import params_from_jax
from gist_tpu_torch.data.container import Dataset
from gist_tpu_torch.graph import graph_from_edges
from gist_tpu_torch.ist.distributed import build_ist_round
from gist_tpu_torch.ist.partition import boundary_sizes, sample_boundaries
from gist_tpu_torch.ist.slicing import dispatch, merge, stack
from gist_tpu_torch.ist.ultrawide import (build_local_burst_single,
                                          subnet_generator)
from gist_tpu_torch.models import gat, gcn, sage
from gist_tpu_torch.models.common import masked_accuracy, micro_f1
from gist_tpu_torch.parallel import comm
from gist_tpu_torch.sampler import (ClusterBatch, ClusterSampler,
                                    bucket_size, unify_tile_buckets)
from gist_tpu_torch.train.checkpoint import (generator_state,
                                             latest_round_dir,
                                             load_checkpoint,
                                             restore_generator,
                                             save_checkpoint)
from gist_tpu_torch.train.common import TrainConfig, reference_lr_schedule
from gist_tpu_torch.utils import draw_seed, resolve_device


def _batches_to_device(batches: List[ClusterBatch],
                       device) -> List[ClusterBatch]:
    """A round's batches with their dedup layouts re-padded to one
    bucket, moved to ``device`` (the part of the JAX package's
    ``_stack_batches`` that a Python loop over batches still needs)."""
    return [b.to(device) for b in unify_tile_buckets(batches)]


class _RoundCollector:
    """Pulls batches off the sampler epoch by epoch, padding each round
    to its max node and edge buckets.  ``ids_only=True`` ships node ids
    instead of per-batch feature tensors (pair with
    ``sampler.tables()``)."""

    def __init__(self, sampler: ClusterSampler, spr: int,
                 ids_only: bool = False):
        self.sampler = sampler
        self.spr = spr
        self.ids_only = ids_only
        self._gen = sampler.iter_node_ids()

    def collect(self) -> List[ClusterBatch]:
        id_sets = [next(self._gen) for _ in range(self.spr)]
        node_pad = max(bucket_size(len(ids)) for ids in id_sets)
        # extract each subgraph once, size the shared edge bucket
        edges = [self.sampler.csr_subgraph(ids) for ids in id_sets]
        edge_pad = max(bucket_size(max(len(s), 1)) for s, _ in edges)
        return [self.sampler.make_batch(ids, node_pad=node_pad,
                                        edge_pad=edge_pad, edges=e,
                                        ids_only=self.ids_only)
                for ids, e in zip(id_sets, edges)]


KIND_MODELS = {"sage": sage, "gcn": gcn, "gat": gat}


def check_kind(model, kind: str) -> None:
    """Raise unless ``kind`` names the module of ``model``: the kind
    picks how the params are sliced and merged."""
    if kind not in KIND_MODELS:
        raise ValueError(f"kind must be sage, gcn or gat, not {kind!r}")
    if model is not KIND_MODELS[kind]:
        raise ValueError(f"kind {kind!r} slices the params of "
                         f"models.{kind}, not of {model.__name__}")


def train_ist_cluster(
    ds: Dataset,
    model_cfg,
    tc: TrainConfig,
    *,
    psize: int = 1500,
    batch_size: int = 20,
    use_pp: bool = False,
    use_f1: bool = False,
    normalize: bool = False,
    cache_dir: Optional[str] = None,
    model=sage,
    kind: str = "sage",
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    lsgd: bool = False,
    init_params: Optional[dict] = None,
    device="cuda",
    verbose: bool = True,
) -> dict:
    """Train ``model`` (``sage`` with kind "sage", ``gcn`` with kind
    "gcn", ``gat`` with kind "gat") with GIST on ``device``.  GAT splits
    the hidden boundaries only; SAGE and GCN split their hidden
    boundaries and the last one; ``lsgd`` splits none.  ``use_pp``
    hands the model precomputed first-layer features (SAGE with a
    ``use_pp`` config).  ``init_params`` (a numpy parameter tree, e.g.
    the JAX package's ``init`` output) replaces the seeded
    initialisation.  ``mesh`` (a ``subnet`` mesh of K ranks on
    ``device``'s type) trains the subnets one a rank."""
    check_kind(model, kind)
    dev = resolve_device(device)
    if mesh is not None:
        if mesh.device_type != torch.device(device).type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the run "
                             f"asks for {device}")
        dev = comm.mesh_device(mesh)
    rank0 = mesh is None or mesh.get_local_rank("subnet") == 0
    K = tc.num_subnet
    if normalize:
        ds.normalize_features()
    sampler = ClusterSampler(ds, psize, batch_size, use_pp=use_pp,
                             cache_dir=cache_dir, seed=tc.seed)
    full_graph = graph_from_edges(ds.senders, ds.receivers,
                                  ds.n_nodes).to(dev)
    fx = torch.from_numpy(ds.features).to(dev)
    flabels = torch.from_numpy(ds.labels).to(dev)
    val_mask = torch.from_numpy(ds.val_mask).to(dev)
    test_mask = torch.from_numpy(ds.test_mask).to(dev)

    if init_params is None:
        full_params = model.init(
            torch.Generator(device=dev).manual_seed(tc.seed), model_cfg)
    else:
        full_params = params_from_jax(init_params, dev)
    if lsgd:
        # dispatch copies the full model, merge averages every leaf
        sub_cfg = model_cfg
        sizes = [None] * (len(full_params["layers"]) + 1)
    elif kind == "gat":
        sub_cfg = model_cfg.sub_config(num_subnet=K)
        sizes = [None] + [model_cfg.n_hidden] * (model_cfg.n_layers - 1) \
            + [None]
    else:
        sub_cfg = model_cfg.sub_config(split_input=False, split_output=True,
                                       num_subnet=K)
        sizes = boundary_sizes(model_cfg.in_feats, model_cfg.n_hidden,
                               model_cfg.n_layers, split_input=False,
                               split_output=True)
    if mesh is None:
        burst = build_local_burst_single(model, sub_cfg,
                                         weight_decay=tc.weight_decay)
    else:
        round_fn = build_ist_round(model, sub_cfg, mesh=mesh, kind=kind,
                                   num_subnet=K,
                                   weight_decay=tc.weight_decay,
                                   split_input=False,
                                   per_subnet_batches=lsgd)

    # the full graph carries no layout: the eval takes the segment path;
    # under a mesh rank 0 evaluates and hands the accuracies to the rest
    def evaluate(params):
        if mesh is not None:
            return comm.broadcast_object(
                _evaluate(params) if rank0 else None, src=0,
                group=mesh.get_group("subnet"))
        return _evaluate(params)

    def _evaluate(params):
        with torch.no_grad():
            logits = model.apply(params, full_graph, fx, model_cfg,
                                 backend="segment")
        if use_f1:
            lg = logits.cpu().numpy()
            return (micro_f1(lg, ds.labels, ds.val_mask),
                    micro_f1(lg, ds.labels, ds.test_mask))
        return (float(masked_accuracy(logits, flabels, val_mask)),
                float(masked_accuracy(logits, flabels, test_mask)))

    # local epochs: n_epochs // num_subnet
    local_epochs = max(tc.n_epochs // K, 1)
    n_rounds = max(local_epochs * len(sampler) // tc.iter_per_site, 1)
    # lsgd: one collection of K * iter_per_site batches a round (one
    # padding bucket), worker s taking the s-th iter_per_site of them
    collector = _RoundCollector(
        sampler, tc.iter_per_site * K if lsgd else tc.iter_per_site,
        ids_only=True)
    tables = sampler.tables(dev)
    part_gen = torch.Generator().manual_seed(tc.seed + 1)
    drop_gen = torch.Generator(device=dev).manual_seed(tc.dropout_seed)

    total_time = 0.0
    total_edges = 0
    val_accs, test_accs, losses, eval_times = [], [], [], []
    edges_per_batch, round_wall = [], []
    steps_per_eval = max(len(sampler), 1)
    steps_done = 0
    next_eval = steps_per_eval
    start_round = 0

    if checkpoint_dir:
        ck = latest_round_dir(checkpoint_dir)
        if ck is not None:
            state = load_checkpoint(ck)
            full_params = {"layers": [
                {k: v.to(dev) for k, v in layer.items()}
                for layer in state["params"]["layers"]]}
            restore_generator(part_gen, state["part_gen"])
            restore_generator(drop_gen, state["drop_gen"])
            start_round = int(state["round"]) + 1
            steps_done, next_eval = state["steps_done"], state["next_eval"]
            if verbose:
                print(f"resumed from {ck} (round {start_round})",
                      flush=True)
            # replay the sampler's stream so the cluster order continues
            for _ in range(start_round):
                collector.collect()

    if start_round >= n_rounds:
        # a finished run's checkpoint: evaluate it only
        va, ta = evaluate(full_params)
        val_accs.append(va)
        test_accs.append(ta)
        eval_times.append(0.0)
        losses.append(float("nan"))

    # the next round's host-side batch build overlaps the card's work
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        pending = pool.submit(collector.collect) \
            if start_round < n_rounds else None
        for rnd in range(start_round, n_rounds):
            batches = pending.result()
            pending = pool.submit(collector.collect) \
                if rnd + 1 < n_rounds else None
            edges_per_batch.extend(b.n_real_edges for b in batches)
            dev_batches = _batches_to_device(batches, dev)
            bnds = [None if b is None else b.to(dev)
                    for b in sample_boundaries(part_gen, sizes, K)]
            lr = reference_lr_schedule(tc.lr, n_rounds, rnd) \
                if tc.lr_schedule else tc.lr
            seed = draw_seed(drop_gen)
            t0 = time.time()
            spr = tc.iter_per_site
            per_subnet = [dev_batches[s * spr:(s + 1) * spr] if lsgd
                          else dev_batches for s in range(K)]
            if mesh is not None:
                full_params, rl = round_fn(
                    full_params, bnds, per_subnet if lsgd else dev_batches,
                    lr, seed, tables)
            else:
                trained, round_losses = [], []
                for s in range(K):
                    sub, r = burst(dispatch(full_params, bnds, s, kind),
                                   per_subnet[s], lr,
                                   subnet_generator(seed, s, dev), tables)
                    trained.append(sub)
                    round_losses.append(r)
                full_params = merge(full_params, bnds, stack(trained), K,
                                    kind)
                rl = torch.stack(round_losses)
            losses.append(float(rl.mean()))
            wall = time.time() - t0
            total_time += wall
            round_wall.append(wall)
            total_edges += sum(b.n_real_edges for b in batches) * K
            steps_done += tc.iter_per_site
            if steps_done >= next_eval or rnd == n_rounds - 1:
                next_eval += steps_per_eval
                va, ta = evaluate(full_params)
                val_accs.append(va)
                test_accs.append(ta)
                eval_times.append(total_time)   # time-to-accuracy curve
                if verbose and rank0:
                    print(f"round {rnd}/{n_rounds}: loss {losses[-1]:.4f} "
                          f"val {va:.4f}", flush=True)
                if checkpoint_dir and rank0:
                    save_checkpoint(
                        os.path.join(checkpoint_dir, f"round_{rnd}"),
                        {"params": full_params, "round": rnd,
                         "part_gen": generator_state(part_gen),
                         "drop_gen": generator_state(drop_gen),
                         "steps_done": steps_done,
                         "next_eval": next_eval})
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    results = {
        "dataset": ds.name, "num_subnet": K, "train_time": total_time,
        "edges_per_sec": total_edges / total_time if total_time else 0.0,
        "last_val": val_accs[-1], "best_val": max(val_accs),
        "last_test": test_accs[-1], "best_test": max(test_accs),
        "val_accs": val_accs, "test_accs": test_accs, "losses": losses,
        "eval_times": eval_times, "round_wall_s": round_wall,
        "edges_per_batch": edges_per_batch,
    }
    if verbose and rank0:
        print(f"Training Time: {total_time:.4f}", flush=True)
        print(f"Last Val: {val_accs[-1]:.4f}", flush=True)
        print(f"Best Val: {max(val_accs):.4f}", flush=True)
        print(f"Last Test: {test_accs[-1]:.4f}", flush=True)
        print(f"Best Test: {max(test_accs):.4f}", flush=True)
    return results
