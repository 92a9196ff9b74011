"""IST over a ``subnet`` mesh on ``torch.distributed``
(``gist_tpu/ist/distributed.py``).

No parameter server: every rank holds the full-width params and draws
the round's boundaries from a generator seeded alike on every rank (or
is handed them), slices its own subnet's shard
(:func:`gist_tpu_torch.ist.slicing.dispatch` with its position on the
mesh), trains it for ``iter_per_site`` steps with a fresh Adam, and
syncs with one all_gather of the trained shards over ``subnet``
followed by the same merge on every rank.  Subnet s's dropout draws from
its own stream, ``utils.fold_in(seed, s)`` of the round's seed, as the
JAX round folds its key with the subnet's index; the single-card loops
draw subnet s's masks the same way, so a mesh round equals a loop round.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from gist_tpu_torch.ist.partition import boundary_sizes, sample_boundaries
from gist_tpu_torch.ist.slicing import dispatch, merge
from gist_tpu_torch.ist.ultrawide import local_train, subnet_generator
from gist_tpu_torch.models.common import masked_accuracy
from gist_tpu_torch.parallel import comm
from gist_tpu_torch.utils import draw_seed


def make_subnet_mesh(num_subnet: int, device="cuda"):
    """The 1-D ``("subnet",)`` mesh over every rank of the process group
    (its world size must be ``num_subnet``)."""
    return comm.make_mesh(device, (num_subnet,), ("subnet",))


def build_ist_round(model, sub_cfg, *, mesh, kind: str, num_subnet: int,
                    weight_decay: float, split_input: bool,
                    sync: bool = True,
                    per_subnet_batches: bool = False) -> Callable:
    """``full_params, losses = round_fn(full_params, bnds, batches, lr,
    seed, tables)`` on this rank of the ``subnet`` mesh.

    ``batches`` is the round's list of batches, the same on every rank
    (every subnet consumes one stream), as inline (graph, feats, labels,
    mask) tuples with ``tables=None`` or as ClusterBatches (ids form
    with the sampler's ``tables``); with ``per_subnet_batches`` it is a
    list of ``num_subnet`` such lists, subnet s taking the s-th.
    ``seed`` is the round's dropout seed.  ``losses`` is
    (num_subnet, steps), every subnet's, on every rank.  ``sync=False``
    skips the gather and merge and returns the params unchanged."""
    s = mesh.get_local_rank("subnet")
    group = mesh.get_group("subnet")
    device = comm.mesh_device(mesh)

    def round_fn(full_params, bnds, batches, lr, seed, tables):
        mine = batches[s] if per_subnet_batches else batches
        feat_idx = bnds[0][s] if split_input and bnds[0] is not None \
            else None
        sub, losses = local_train(
            model, sub_cfg, dispatch(full_params, bnds, s, kind), mine, lr,
            weight_decay, subnet_generator(seed, s, device), tables,
            feat_idx)
        if sync:
            stacked = comm.all_gather_tree(sub, group)
            full_params = merge(full_params, bnds, stacked, num_subnet, kind)
        return full_params, comm.all_gather_stack(losses, group)

    return round_fn


def run_distributed_ist(ds, model_cfg, tc, *, model, kind: str = "gcn",
                        mesh=None, n_rounds: Optional[int] = None,
                        steps_per_round: Optional[int] = None,
                        init_params: Optional[dict] = None,
                        device="cuda", verbose: bool = True) -> dict:
    """Full-graph distributed IST (the small-graph regime): every local
    step uses the whole graph, the K subnets on the K ranks of the
    ``subnet`` mesh.  The process group must be initialised with K
    ranks; ``mesh`` defaults to :func:`make_subnet_mesh` over them.
    ``init_params`` (a numpy tree) replaces the seeded initialisation.
    Rank 0 evaluates the merged model each round and every rank returns
    its results."""
    from gist_tpu_torch.convert import params_from_jax
    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.train.common import (reference_lr_schedule,
                                             seeded_init)

    K = tc.num_subnet
    mesh = mesh or make_subnet_mesh(K, device)
    dev = comm.mesh_device(mesh)
    graph = graph_from_edges(ds.senders, ds.receivers, ds.n_nodes).to(dev)
    x = torch.from_numpy(ds.features).to(dev)
    labels = torch.from_numpy(ds.labels).to(dev)
    train_mask = torch.from_numpy(ds.train_mask).to(dev)
    val_mask = torch.from_numpy(ds.val_mask).to(dev)
    test_mask = torch.from_numpy(ds.test_mask).to(dev)

    if init_params is None:
        full_params = seeded_init(model, model_cfg, tc.seed, dev)
    else:
        full_params = params_from_jax(init_params, dev)
    sub_cfg = model_cfg.sub_config(split_input=tc.split_input,
                                   split_output=tc.split_output,
                                   num_subnet=K)
    sizes = boundary_sizes(model_cfg.in_feats, model_cfg.n_hidden,
                           model_cfg.n_layers, split_input=tc.split_input,
                           split_output=tc.split_output)
    round_fn = build_ist_round(model, sub_cfg, mesh=mesh, kind=kind,
                               num_subnet=K, weight_decay=tc.weight_decay,
                               split_input=tc.split_input)
    spr = steps_per_round or tc.iter_per_site
    n_rounds = n_rounds or max(tc.n_epochs // spr, 1)
    batches = [(graph, x, labels, train_mask)] * spr
    part_gen = torch.Generator().manual_seed(tc.seed + 1)
    drop_gen = torch.Generator().manual_seed(tc.dropout_seed)
    rank0 = mesh.get_local_rank("subnet") == 0

    val_accs, test_accs, losses = [], [], []
    t0 = time.time()
    for rnd in range(n_rounds):
        bnds = [None if b is None else b.to(dev)
                for b in sample_boundaries(part_gen, sizes, K)]
        lr = reference_lr_schedule(tc.lr, n_rounds * spr, rnd * spr)
        full_params, rl = round_fn(full_params, bnds, batches, lr,
                                   draw_seed(drop_gen), None)
        accs = None
        if rank0:
            with torch.no_grad():
                logits = model.apply(full_params, graph, x, model_cfg)
            accs = (float(masked_accuracy(logits, labels, val_mask)),
                    float(masked_accuracy(logits, labels, test_mask)))
        va, ta = comm.broadcast_object(accs, src=0,
                                       group=mesh.get_group("subnet"))
        val_accs.append(va)
        test_accs.append(ta)
        losses.append(float(rl.mean()))
        if verbose and rank0:
            print(f"round {rnd}: loss {losses[-1]:.4f} val {va:.4f}",
                  flush=True)
    total = time.time() - t0
    return {
        "dataset": ds.name, "num_subnet": K, "train_time": total,
        "final_test_acc": test_accs[-1], "best_val_acc": max(val_accs),
        "best_test_acc": max(test_accs), "val_accs": val_accs,
        "test_accs": test_accs, "losses": losses,
    }
