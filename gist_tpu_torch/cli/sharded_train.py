"""Graph-sharded full-graph training CLI (``gist_tpu/cli/sharded_train.py``):
nodes, edges and features partitioned over the ranks, each layer
exchanging one ring halo of boundary rows.  ``--model`` picks the
family: sage (mean aggregation, concat), gcn (symmetric norm and
whole-tensor LayerNorm, self loops added) or gat (multi-head attention,
the softmax local to the receiver's rank).  ``--ist-subnets S > 1``
trains on the 2-D (subnet, graph) mesh instead: IST rounds whose local
steps run the graph-sharded forward.

One process per rank, launched by ``torchrun``:

    torchrun --nproc-per-node 2 -m gist_tpu_torch.cli.sharded_train \\
        --dataset synth-tiny --n-devices 2 --model sage [--device cpu]

``--n-devices`` must equal the world size.  Ranks on the one card of a
one-card host cannot share an NCCL communicator, so pass ``--backend
gloo`` there (the payloads of CUDA tensors then go through host memory).
Run without a launcher, the CLI is one rank.  Rank 0 prints and writes
``--result-json``; every rank returns the results.
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from gist_tpu_torch.cli.common import add_common_args, apply_backend, str2bool


def _join_group(args, device, work: str) -> bool:
    """Join the launcher's process group, or start a one-rank group
    without a launcher (its rendezvous file in ``work``); True when this
    call created it."""
    import torch.distributed as dist

    from gist_tpu_torch.multihost import init_multihost
    if dist.is_initialized():
        return False
    if init_multihost(backend=args.backend, device=device):
        return True
    return init_multihost(f"file://{os.path.join(work, 'rdv')}", 1, 0,
                          backend=args.backend, device=device)


def _accuracies(args, ds, logits: np.ndarray):
    from gist_tpu_torch.models.common import micro_f1
    if args.use_f1:
        return (micro_f1(logits, ds.labels, ds.val_mask),
                micro_f1(logits, ds.labels, ds.test_mask))
    pred = logits.argmax(-1)
    va = float((pred[ds.val_mask] == ds.labels[ds.val_mask]).mean())
    ta = float((pred[ds.test_mask] == ds.labels[ds.test_mask]).mean())
    return va, ta


def _model(args, ds, use_ln, dropout):
    from gist_tpu_torch.models import gat, gcn, sage
    if args.model == "sage":
        return sage, sage.SAGEConfig(ds.in_feats, args.n_hidden,
                                     ds.n_classes, n_layers=args.n_layers,
                                     dropout=0.0, use_layernorm=use_ln)
    if args.model == "gcn":
        return gcn, gcn.GCNConfig(ds.in_feats, args.n_hidden, ds.n_classes,
                                  n_layers=args.n_layers, dropout=dropout,
                                  use_layernorm=use_ln)
    return gat, gat.GATConfig(ds.in_feats, args.n_hidden, ds.n_classes,
                              n_layers=max(args.n_layers, 2),
                              n_heads=args.n_heads)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _local_rows(sg, a, rank, device):
    from gist_tpu_torch.parallel.graph_shard import shard_rows
    rows = shard_rows(sg, a)[rank * sg.n_loc_pad:(rank + 1) * sg.n_loc_pad]
    return torch.from_numpy(rows).to(device)


def main(argv=None):
    p = argparse.ArgumentParser(description="sharded full-graph GNN")
    add_common_args(p)
    p.add_argument("--model", choices=["sage", "gcn", "gat"],
                   default="sage")
    p.add_argument("--n-heads", type=int, default=2,
                   help="GAT attention heads")
    p.add_argument("--n-devices", type=int, default=None,
                   help="ranks to shard over; must equal the world size "
                        "(default: the world size)")
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--use-f1", action="store_true")
    p.add_argument("--halo-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="wire dtype of the ring halo exchange; bfloat16 "
                        "halves its bytes at fp32 compute")
    p.add_argument("--ist-subnets", type=int, default=1,
                   help="> 1 trains on the 2-D (subnet, graph) mesh: IST "
                        "hidden-width sharding composed with graph "
                        "sharding; ranks = subnets x graph shards")
    p.add_argument("--iter_per_site", type=int, default=8,
                   help="local full-graph steps per IST round (2-D mode; "
                        "--n-epochs counts rounds there)")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="torch.distributed backend (default: nccl on "
                        "cuda, gloo on cpu)")
    args = p.parse_args(argv)
    device = apply_backend(args)

    import torch.distributed as dist
    with tempfile.TemporaryDirectory(prefix="sharded_train_") as work:
        created = _join_group(args, device, work)
        try:
            return _run(args, device)
        finally:
            if created:
                dist.destroy_process_group()


def _run(args, device):
    import torch.distributed as dist

    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.parallel import build_sharded_graph, comm
    from gist_tpu_torch.parallel.graph_shard import (gather_unshard,
                                                     shard_features)
    from gist_tpu_torch.parallel.train import (build_sharded_infer,
                                               build_sharded_step)
    from gist_tpu_torch.train.common import seeded_init, write_results
    from gist_tpu_torch.utils import fold_in

    world = dist.get_world_size()
    d = args.n_devices or world
    if d != world:
        raise SystemExit(f"--n-devices {d} must equal the world size "
                         f"{world} (launch with torchrun --nproc-per-node "
                         f"{d})")
    rank0 = dist.get_rank() == 0
    ds = load_dataset(args.dataset, args.data_root)
    if args.normalize:
        ds.normalize_features()
    if rank0:
        print(ds.summary(), flush=True)

    senders, receivers = ds.senders, ds.receivers
    if args.model == "gcn":
        # the reference GCN trains with self loops
        loops = np.arange(ds.n_nodes)
        senders = np.concatenate([senders, loops])
        receivers = np.concatenate([receivers, loops])
    if args.ist_subnets > 1:
        return _main_2d(args, ds, d, senders, receivers, device)

    mesh = comm.make_mesh(device, (d,), ("graph",))
    rank = mesh.get_local_rank("graph")
    dev = comm.mesh_device(mesh)
    sg = build_sharded_graph(senders, receivers, ds.n_nodes, d)
    if rank0:
        print(f"sharded over {d} ranks: n_loc_pad={sg.n_loc_pad} "
              f"halo_pad={sg.halo_pad} (halo/replication ratio "
              f"{d * sg.halo_pad / max(ds.n_nodes, 1):.3f}); interior "
              f"tiles {sg.int_dedup is not None}", flush=True)
    xs = shard_features(sg, ds.features, rank, dev)
    labels_sh = _local_rows(sg, ds.labels.astype(np.int32), rank, dev)
    mask_sh = _local_rows(sg, ds.train_mask, rank, dev)

    use_ln = str2bool(args.use_layernorm)
    dropout = args.dropout if args.model == "gcn" else 0.0
    model, cfg = _model(args, ds, use_ln, dropout)
    params = seeded_init(model, cfg, args.rnd_seed, dev)
    hdt = torch.bfloat16 if args.halo_dtype == "bfloat16" else None
    init_opt, step = build_sharded_step(
        sg, mesh, kind=args.model, lr=args.lr,
        weight_decay=args.weight_decay, use_layernorm=use_ln,
        halo_dtype=hdt, dropout=dropout)
    # eval runs the training's wire numerics
    infer = build_sharded_infer(sg, mesh, kind=args.model,
                                use_layernorm=use_ln, halo_dtype=hdt)
    opt = init_opt(params)
    # each rank its own dropout stream
    drop_gen = torch.Generator(device=dev).manual_seed(
        fold_in(args.rnd_seed + 1, rank))
    group = mesh.get_group("graph")

    def evaluate(params):
        logits = gather_unshard(sg, infer(params, xs), group)
        return _accuracies(args, ds, logits.cpu().numpy())

    total = 0.0
    val_accs, test_accs, losses = [], [], []
    for epoch in range(args.n_epochs):
        t0 = time.time()
        params, opt, loss = step(params, opt, xs, labels_sh, mask_sh,
                                 drop_gen if dropout > 0 else None)
        _sync(dev)
        if epoch >= 3:
            total += time.time() - t0
        losses.append(float(loss))
        va, ta = evaluate(params)
        val_accs.append(va)
        test_accs.append(ta)

    eps = ds.n_edges * max(args.n_epochs - 3, 1) / total if total else 0.0
    results = {
        "dataset": ds.name, "model": args.model, "n_devices": d,
        "train_time": total,
        "edges_per_sec": eps, "edges_per_sec_per_chip": eps / d,
        "final_test_acc": test_accs[-1], "best_val_acc": max(val_accs),
        "best_test_acc": max(test_accs), "val_accs": val_accs,
        "test_accs": test_accs, "losses": losses,
        "interior_tiles": sg.int_dedup is not None,
    }
    if rank0:
        print(f"Training Time: {total:.4f}")
        print(f"Best Val: {max(val_accs):.4f}")
        print(f"Best Test: {max(test_accs):.4f}")
        print(f"edges/sec: {eps:.0f}", flush=True)
        write_results(results, args.result_json)
    return results


def _main_2d(args, ds, d, senders, receivers, device):
    """2-D (subnet, graph) training: IST rounds whose local steps run
    the graph-sharded forward of ``--model``.  ``--n-epochs`` counts
    rounds; each round does ``--iter_per_site`` full-graph steps per
    subnet, then one all_gather sync.  Rank 0 evaluates the merged
    full-width model on the flat graph (segment path) and hands the
    accuracies to every rank.  The round's loss is subnet 0's mean, as
    the JAX CLI reads its round's losses."""
    import torch.distributed as dist

    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.ist.partition import boundary_sizes, sample_boundaries
    from gist_tpu_torch.parallel import build_sharded_graph, comm
    from gist_tpu_torch.parallel.graph_shard import shard_features
    from gist_tpu_torch.parallel.ist_sharded import (build_ist_sharded_round,
                                                     make_ist_graph_mesh)
    from gist_tpu_torch.train.common import seeded_init, write_results

    S = args.ist_subnets
    if d % S:
        raise SystemExit(f"--n-devices {d} not divisible by "
                         f"--ist-subnets {S}")
    Gd = d // S
    rank0 = dist.get_rank() == 0
    use_ln = str2bool(args.use_layernorm)
    mesh = make_ist_graph_mesh(S, Gd, device)
    g_rank = mesh.get_local_rank("graph")
    dev = comm.mesh_device(mesh)
    sg = build_sharded_graph(senders, receivers, ds.n_nodes, Gd)
    if rank0:
        print(f"2-D mesh: subnet={S} x graph={Gd}; n_loc_pad={sg.n_loc_pad};"
              f" interior tiles {sg.int_dedup is not None}", flush=True)
    xs = shard_features(sg, ds.features, g_rank, dev)
    lab = _local_rows(sg, ds.labels.astype(np.int32), g_rank, dev)
    msk = _local_rows(sg, ds.train_mask, g_rank, dev)

    model, cfg = _model(args, ds, use_ln, 0.0)
    full = seeded_init(model, cfg, args.rnd_seed, dev)
    # GAT never splits the last hidden boundary: its shared last-layer
    # attention would train against disjoint halves
    sizes = boundary_sizes(cfg.in_feats, cfg.n_hidden, cfg.n_layers,
                           split_input=False,
                           split_output=args.model != "gat")
    hdt = torch.bfloat16 if args.halo_dtype == "bfloat16" else None
    round_fn = build_ist_sharded_round(
        sg, mesh, num_subnet=S, kind=args.model,
        weight_decay=args.weight_decay, use_layernorm=use_ln,
        n_steps=args.iter_per_site, halo_dtype=hdt)

    flat = {}

    def evaluate(params):
        accs = None
        if rank0:
            if not flat:
                flat["g"] = graph_from_edges(senders, receivers,
                                             ds.n_nodes).to(dev)
                flat["x"] = torch.from_numpy(ds.features).to(dev)
            with torch.no_grad():
                logits = model.apply(params, flat["g"], flat["x"], cfg,
                                     backend="segment")
            accs = _accuracies(args, ds, logits.cpu().numpy())
        return comm.broadcast_object(accs, src=0)

    part_gen = torch.Generator().manual_seed(args.rnd_seed + 1)
    total = 0.0
    val_accs, test_accs, losses = [], [], []
    for rnd in range(args.n_epochs):
        bnds = [None if b is None else b.to(dev)
                for b in sample_boundaries(part_gen, sizes, S)]
        t0 = time.time()
        full, rl = round_fn(full, bnds, xs, lab, msk, args.lr)
        _sync(dev)
        total += time.time() - t0
        losses.append(float(rl[0].mean()))
        va, ta = evaluate(full)
        val_accs.append(va)
        test_accs.append(ta)
        if rank0:
            print(f"round {rnd}: loss {losses[-1]:.4f} val {va:.4f}",
                  flush=True)

    results = {
        "dataset": ds.name, "model": args.model, "mesh_2d": [S, Gd],
        "n_devices": d, "iter_per_site": args.iter_per_site,
        "train_time": total, "final_test_acc": test_accs[-1],
        "best_val_acc": max(val_accs), "best_test_acc": max(test_accs),
        "val_accs": val_accs, "test_accs": test_accs, "losses": losses,
        "comm_per_step_layer0": sg.comm_stats(f=ds.in_feats),
        "interior_tiles": sg.int_dedup is not None,
    }
    if rank0:
        print(f"Training Time: {total:.4f}")
        print(f"Best Val: {max(val_accs):.4f}")
        print(f"Best Test: {max(test_accs):.4f}", flush=True)
        write_results(results, args.result_json)
    return results


if __name__ == "__main__":
    main()
