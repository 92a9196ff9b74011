"""IST on the 2-D (subnet x graph) mesh trained end to end, beside a 1-D
IST control (``benchmarks/ist_sharded_2d.py``).

    python -m gist_tpu_torch.bench.ist_sharded_2d [--subnets 2] [--graph 4]
        [--rounds 12] [--steps 8] [--hidden 128]
        [--dataset synth-reddit-small] [--backend nccl|gloo]
        [--device cuda|cpu] [--out results/torch_ist_sharded_2d.json]

The JAX script's configuration (its ``IST2D_*`` variables become the
flags): synth-reddit-small, SAGE h128 with 2 layers, dropout 0, lr 1e-2,
12 rounds of 8 local steps, on S=2 subnets x G=4 graph shards.  Each
round draws one set of boundaries (a CPU generator seeded 11) for both
runs, from the same initial params (a CPU generator seeded 0):

* the 2-D run: ``parallel/ist_sharded.py:build_ist_sharded_round``,
  each subnet's full-graph steps sharded over its row of the mesh (K1
  on the interior tiles, the ring halo between ranks);
* the 1-D control: the same K and boundary keys, full-graph steps on a
  subnet-only mesh (``ist/distributed.py:build_ist_round`` over the 2-D
  mesh's ``subnet`` dim, every graph column running it alike), the flat
  graph without layouts (the segment path).

Both do the same math, so their curves must coincide to float tolerance.
After each round rank 0 evaluates both merged models on the flat graph
(val and test accuracy) and hands the numbers to every rank.  The record
holds both curves, each round's wall and subnet 0's mean loss (as
``cli.sharded_train`` reads a round's loss), the largest val gap, the
per-step comm accounting of a layer-0 and a layer-1 halo
(``ShardedGraph.comm_stats``), the kept ring shifts, the backend, the
card's name and power limit and this rank's kernel launches.

Run as above, the script starts the S x G ranks itself, each a process
of its own (:func:`procs.run_children`; ``--backend`` defaults to nccl
when every rank has a card, gloo when ranks share one, and gloo on the
CPU), rank 0 writes ``--out`` and the script prints its line.  A caller
that already holds a process group of S x G ranks calls :func:`run`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from gist_tpu_torch.bench import common

DEFAULT_OUT = common.results_path("ist_sharded_2d")
LR = 1e-2


def _local_rows(sg, a, rank, device):
    from gist_tpu_torch.parallel.graph_shard import shard_rows
    rows = shard_rows(sg, a)[rank * sg.n_loc_pad:(rank + 1) * sg.n_loc_pad]
    return torch.from_numpy(np.ascontiguousarray(rows)).to(device)


def run(ds, device, *, subnets: int = 2, graph: int = 4, rounds: int = 12,
        steps: int = 8, hidden: int = 128, lr: float = LR, halo_dtype=None,
        init_params=None, boundaries=None) -> dict:
    """Both runs on this rank of an initialised group of ``subnets x
    graph`` ranks.  ``init_params`` (a numpy tree) replaces the seeded
    init; ``boundaries`` (one numpy list a round) the seeded draws.  The
    record carries the two runs' final params (``params_2d``,
    ``params_1d``, numpy) beside what the script writes."""
    import torch.distributed as dist

    from gist_tpu_torch.convert import params_from_jax, params_to_numpy
    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.ist.distributed import build_ist_round
    from gist_tpu_torch.ist.partition import (boundary_sizes,
                                              sample_boundaries)
    from gist_tpu_torch.models import sage
    from gist_tpu_torch.parallel import build_sharded_graph, comm
    from gist_tpu_torch.parallel.graph_shard import shard_features
    from gist_tpu_torch.parallel.ist_sharded import (build_ist_sharded_round,
                                                     make_ist_graph_mesh)
    from gist_tpu_torch.train.common import seeded_init

    before = common.launch_counts()
    mesh = make_ist_graph_mesh(subnets, graph, device)
    dev = comm.mesh_device(mesh)
    g_rank = mesh.get_local_rank("graph")
    rank0 = dist.get_rank() == 0
    cfg = sage.SAGEConfig(ds.in_feats, hidden, ds.n_classes, n_layers=2,
                          dropout=0.0)
    sizes = boundary_sizes(cfg.in_feats, cfg.n_hidden, cfg.n_layers,
                           split_input=False, split_output=True)
    full0 = seeded_init(sage, cfg, 0, dev) if init_params is None \
        else params_from_jax(init_params, dev)

    sg = build_sharded_graph(ds.senders, ds.receivers, ds.n_nodes, graph)
    xs = shard_features(sg, ds.features, g_rank, dev)
    lab = _local_rows(sg, ds.labels.astype(np.int32), g_rank, dev)
    msk = _local_rows(sg, ds.train_mask, g_rank, dev)
    round2d = build_ist_sharded_round(sg, mesh, num_subnet=subnets,
                                      kind="sage", weight_decay=0.0,
                                      n_steps=steps, halo_dtype=halo_dtype)

    g_flat = graph_from_edges(ds.senders, ds.receivers, ds.n_nodes).to(dev)
    x_flat = torch.from_numpy(ds.features).to(dev)
    labels = torch.from_numpy(ds.labels).to(dev)
    train_mask = torch.from_numpy(ds.train_mask).to(dev)
    sub_cfg = cfg.sub_config(split_input=False, split_output=True,
                             num_subnet=subnets)
    round1d = build_ist_round(sage, sub_cfg, mesh=mesh, kind="sage",
                              num_subnet=subnets, weight_decay=0.0,
                              split_input=False)
    batches1 = [(g_flat, x_flat, labels, train_mask)] * steps

    def evaluate(params):
        accs = None
        if rank0:
            with torch.no_grad():
                pred = sage.apply(params, g_flat, x_flat, cfg,
                                  backend="segment").argmax(-1).cpu().numpy()
            accs = [float((pred[m] == ds.labels[m]).mean())
                    for m in (ds.val_mask, ds.test_mask)]
        return comm.broadcast_object(accs, src=0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    part_gen = torch.Generator().manual_seed(11)
    params = {"2d": full0, "1d": {"layers": [
        {k: v.clone() for k, v in l.items()} for l in full0["layers"]]}}
    curves = {t: {"val": [], "test": [], "wall": [], "loss": []}
              for t in params}
    for rnd in range(rounds):
        if boundaries is None:
            bnds = sample_boundaries(part_gen, sizes, subnets)
        else:
            bnds = [None if b is None else torch.from_numpy(np.asarray(b))
                    for b in boundaries[rnd]]
        bnds = [None if b is None else b.long().to(dev) for b in bnds]
        for tag in params:
            t0 = time.time()
            if tag == "2d":
                params[tag], rl = round2d(params[tag], bnds, xs, lab, msk,
                                          lr)
            else:
                params[tag], rl = round1d(params[tag], bnds, batches1, lr, 0,
                                          None)
            sync()
            curves[tag]["wall"].append(time.time() - t0)
            curves[tag]["loss"].append(float(rl[0].mean()))
        for tag in params:
            va, ta = evaluate(params[tag])
            curves[tag]["val"].append(va)
            curves[tag]["test"].append(ta)
        if rank0:
            print(f"round {rnd}: 2d val {curves['2d']['val'][-1]:.4f} "
                  f"({curves['2d']['wall'][-1]:.2f}s)  1d val "
                  f"{curves['1d']['val'][-1]:.4f} "
                  f"({curves['1d']['wall'][-1]:.2f}s)", file=sys.stderr,
                  flush=True)
    gap = float(np.max(np.abs(np.subtract(curves["2d"]["val"],
                                          curves["1d"]["val"]))))
    return {
        "dataset": ds.name, "mesh": [subnets, graph],
        "world": dist.get_world_size(), "backend": dist.get_backend(),
        "hidden": hidden, "n_layers": 2, "rounds": rounds,
        "steps_per_round": steps, "lr": lr,
        "halo_dtype": str(halo_dtype or torch.float32).split(".")[-1],
        **common.hardware(dev), "curves": curves,
        "best_val_2d": max(curves["2d"]["val"]),
        "best_val_1d": max(curves["1d"]["val"]),
        "max_val_gap_2d_vs_1d": gap,
        "comm_per_step": {"layer0": sg.comm_stats(f=ds.in_feats),
                          "layer1": sg.comm_stats(f=hidden)},
        "ring_shifts_kept": len(sg.ring_shifts),
        "interior_tiles": sg.int_dedup is not None,
        "kernel_launches": common.launches_since(before),
        "params_2d": params_to_numpy(params["2d"]),
        "params_1d": params_to_numpy(params["1d"])}


def _rank_main(args) -> int:
    """One rank: join the group, run, rank 0 writes the record."""
    import torch.distributed as dist

    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.multihost import init_multihost
    os.environ["LOCAL_RANK"] = str(args.rank)
    init_multihost(f"file://{os.path.join(args.rdv, 'rdv')}", args.world,
                   args.rank, backend=args.backend, device=args.device)
    try:
        rec = run(load_dataset(args.dataset), args.device,
                  subnets=args.subnets, graph=args.graph, rounds=args.rounds,
                  steps=args.steps, hidden=args.hidden)
        if args.rank == 0:
            for k in ("params_2d", "params_1d"):
                del rec[k]
            common.write_json(os.path.join(args.rdv, "rank0.json"), rec)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--subnets", type=int, default=2)
    p.add_argument("--graph", type=int, default=4)
    p.add_argument("--rounds", type=int, default=12)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--dataset", default="synth-reddit-small")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT)
    # set by the script for the ranks it starts
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--rdv", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    args.world = args.subnets * args.graph
    if args.rank is not None:
        return _rank_main(args)

    def go():
        from gist_tpu_torch.bench import procs
        from gist_tpu_torch.utils import resolve_device
        dev = resolve_device(args.device)
        backend = args.backend or (
            "nccl" if dev.type == "cuda"
            and args.world <= torch.cuda.device_count() else "gloo")
        config = ["--subnets", args.subnets, "--graph", args.graph,
                  "--rounds", args.rounds, "--steps", args.steps,
                  "--hidden", args.hidden, "--dataset", args.dataset,
                  "--device", args.device, "--backend", backend]
        with tempfile.TemporaryDirectory(prefix="ist_sharded_2d_") as rdv:
            t0 = time.time()
            procs.run_children(
                [[sys.executable, "-m", "gist_tpu_torch.bench.ist_sharded_2d",
                  *map(str, config), "--rank", str(r), "--rdv", rdv]
                 for r in range(args.world)], check=True, stdout=sys.stderr)
            with open(os.path.join(rdv, "rank0.json"), encoding="utf-8") as fh:
                rec = json.load(fh)
        rec["seconds"] = time.time() - t0
        common.write_json(args.out, rec)
        return rec

    return common.script_main(go)


if __name__ == "__main__":
    raise SystemExit(main())
