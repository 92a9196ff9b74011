"""Multi-rank dry run (``__graft_entry__.dryrun_multichip``): N ranks,
spawned here, each run one IST round over a ``subnet`` mesh of all
ranks and one graph-sharded training step of SAGE, GCN and GAT over a
``graph`` mesh, on synth-tiny.

    python -m gist_tpu_torch.dryrun 8 [--device cpu] [--backend gloo]
        [--link-bytes-per-s RATE --link-name NAME [--t1-ms MS]]

The ranks run on the card (rank r on ``cuda:r % device_count``, the
kernels built here before any rank starts) unless ``--device cpu`` asks
for the CPU.  The backend defaults to ``nccl`` on the card and ``gloo``
on the CPU; NCCL refuses two ranks of one communicator on one card, so
several ranks sharing one card need ``--backend gloo``.  It checks the
plumbing only (finite losses, the same results on every rank); parity
with the JAX package is the tests' job.

The ranks run within ``DEFAULT_TIMEOUT_S`` seconds: past it every rank
still running is ended with its process group and the run raises
``TimeoutError`` (``bench/procs.py:join_spawned``), and each rank's
process group times out at three quarters of it.

Given a link rate (``--link-bytes-per-s`` and ``--link-name``), it also
prints the D-rank scaling projection of the graph-sharded step's graph
(``ShardedGraph.projected_scaling``, the JAX dry run's
``_measured_agg_time`` projection), from the one-device time ``--t1-ms``
or else the port's own sharded D=1 kernel time in
``results/torch_sharded.json`` (:mod:`gist_tpu_torch.bench.sharded`);
without either it raises.  It reads no record of another machine.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

DEFAULT_TIMEOUT_S = 900.0


def _rank(rank: int, n: int, rdv: str, out: str, device: str,
          backend: str, timeout_s: float) -> None:
    import json

    import numpy as np
    import torch
    import torch.distributed as dist

    from gist_tpu_torch.bench import procs
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.ist.distributed import (build_ist_round,
                                                make_subnet_mesh)
    from gist_tpu_torch.ist.partition import boundary_sizes, sample_boundaries
    from gist_tpu_torch.models import gat, gcn, sage
    from gist_tpu_torch.parallel import build_sharded_graph, comm
    from gist_tpu_torch.parallel.graph_shard import shard_features, shard_rows
    from gist_tpu_torch.parallel.train import build_sharded_step

    procs.own_group()
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    if backend == "nccl":
        comm.rank_device(device)
    dist.init_process_group(backend, init_method=f"file://{rdv}", rank=rank,
                            world_size=n,
                            timeout=procs.rank_timeout(timeout_s))
    try:
        ds = load_dataset("synth-tiny")
        hidden = 8 * n
        cfg = sage.SAGEConfig(ds.in_feats, hidden, ds.n_classes, n_layers=2)
        res = {}

        # 1) an IST round: dispatch, local steps, all_gather and merge
        mesh = make_subnet_mesh(n, device)
        dev = comm.mesh_device(mesh)
        graph = graph_from_edges(ds.senders, ds.receivers, ds.n_nodes).to(dev)
        batch = (graph, torch.from_numpy(ds.features).to(dev),
                 torch.from_numpy(ds.labels).to(dev),
                 torch.from_numpy(ds.train_mask).to(dev))
        sizes = boundary_sizes(cfg.in_feats, cfg.n_hidden, cfg.n_layers,
                               split_input=False, split_output=True)
        bnds = [None if b is None else b.to(dev) for b in
                sample_boundaries(torch.Generator().manual_seed(1), sizes, n)]
        round_fn = build_ist_round(
            sage, cfg.sub_config(split_input=False, split_output=True,
                                 num_subnet=n),
            mesh=mesh, kind="sage", num_subnet=n, weight_decay=5e-4,
            split_input=False)
        full = _to(sage.init(torch.Generator().manual_seed(0), cfg), dev)
        _, losses = round_fn(full, bnds, [batch] * 2, 1e-2, 2, None)
        res["ist_round_losses"] = losses.flatten().tolist()

        # 2) graph-sharded steps of the three families
        gmesh = comm.make_mesh(device, (n,), ("graph",))
        loops = np.arange(ds.n_nodes)
        edges = {"sage": (ds.senders, ds.receivers),
                 "gat": (ds.senders, ds.receivers),
                 "gcn": (np.concatenate([ds.senders, loops]),
                         np.concatenate([ds.receivers, loops]))}
        models = {"sage": (sage, cfg),
                  "gcn": (gcn, gcn.GCNConfig(ds.in_feats, hidden,
                                             ds.n_classes, n_layers=1,
                                             dropout=0.0)),
                  "gat": (gat, gat.GATConfig(ds.in_feats, hidden,
                                             ds.n_classes, n_layers=2,
                                             n_heads=2))}
        for kind, (model, mcfg) in models.items():
            sg = build_sharded_graph(*edges[kind], ds.n_nodes, n)
            r, m = rank, sg.n_loc_pad
            lab = torch.from_numpy(
                shard_rows(sg, ds.labels)[r * m:(r + 1) * m]).to(dev)
            msk = torch.from_numpy(
                shard_rows(sg, ds.train_mask)[r * m:(r + 1) * m]).to(dev)
            init_opt, step = build_sharded_step(sg, gmesh, kind=kind, lr=1e-2,
                                                weight_decay=5e-4)
            params = _to(model.init(torch.Generator().manual_seed(3), mcfg),
                         dev)
            _, _, loss = step(params, init_opt(params),
                              shard_features(sg, ds.features, r, dev), lab,
                              msk)
            res[f"{kind}_loss"] = float(loss)
            if kind == "sage":
                res["comm"] = sg.comm_stats(f=ds.in_feats)
                res["interior_tiles"] = sg.int_dedup is not None
                res["ring_shifts"] = [len(sg.ring_shifts), n - 1]
        with open(f"{out}.{rank}", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _to(params: dict, dev) -> dict:
    return {"layers": [{k: v.to(dev) for k, v in l.items()}
                       for l in params["layers"]]}


def _build_kernels() -> None:
    """K1 and K4-K6 compiled once, here, so that no rank compiles."""
    from gist_tpu_torch.ops import dedup_spmm, gat_dedup
    for mod in (dedup_spmm, gat_dedup):
        if not os.path.exists(dedup_spmm.library_path(mod.SOURCE)):
            dedup_spmm.build(mod.SOURCE)


def sharded_t1_ms(path: Optional[str] = None):
    """(ms, source) of the port's sharded D=1 kernel time in ``path``
    (default ``results/torch_sharded.json``, written by
    :mod:`gist_tpu_torch.bench.sharded`), its card and power limit in
    the source; raises where there is none."""
    import json

    from gist_tpu_torch.bench.sharded import DEFAULT_OUT
    path = path or DEFAULT_OUT
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no one-device time for the projection: pass --t1-ms, or run "
            f"python -m gist_tpu_torch.bench.sharded first ({path})")
    with open(path, encoding="utf-8") as f:
        step = json.load(f)["step"]
    return (float(step["sharded_d1_kernel_ms"]),
            f"{path} (sharded D=1, {step['hardware']}, "
            f"{step['power_limit_w']} W)")


def projection(n_devices: int, link_bytes_per_s: float, link_name: str,
               t1_ms: Optional[float] = None,
               t1_path: Optional[str] = None) -> dict:
    """The dry run's projection: the graph-sharded step's graph
    (synth-tiny over ``n_devices`` ranks) projected from ``t1_ms`` (else
    :func:`sharded_t1_ms`) at ``link_bytes_per_s``, fp32 and with bf16
    halos."""
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.parallel import build_sharded_graph
    if t1_ms is None:
        t1_ms, source = sharded_t1_ms(t1_path)
    else:
        source = "--t1-ms"
    ds = load_dataset("synth-tiny")
    sg = build_sharded_graph(ds.senders, ds.receivers, ds.n_nodes,
                             n_devices, interior_tiles=False)
    f = ds.in_feats
    p32 = sg.projected_scaling(t1_ms / 1e3, f,
                               link_bytes_per_s=link_bytes_per_s)
    p16 = sg.projected_scaling(t1_ms / 1e3, f, halo_itemsize=2,
                               link_bytes_per_s=link_bytes_per_s)
    return {**p32, "efficiency_overlap_bf16_halo": p16["efficiency_overlap"],
            "t1_ms": t1_ms, "t1_source": source,
            "link_bytes_per_s": link_bytes_per_s, "link_name": link_name}


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     link_bytes_per_s: Optional[float] = None,
                     link_name: Optional[str] = None,
                     t1_ms: Optional[float] = None) -> dict:
    """Spawn ``n_devices`` ranks on ``device`` (``backend`` defaults to
    ``nccl`` on the card and ``gloo`` on the CPU), run the dry run
    within ``timeout_s`` seconds, print rank 0's summary and return it;
    raises if a loss is not finite or the ranks disagree.  With
    ``link_bytes_per_s`` (and ``link_name``) the summary also holds the
    D-rank projection (:func:`projection`) under ``"projection"``."""
    import json
    import math

    import torch.multiprocessing as mp

    from gist_tpu_torch.bench import procs
    from gist_tpu_torch.parallel.comm import default_backend
    from gist_tpu_torch.utils import resolve_device
    if (link_bytes_per_s is None) != (link_name is None):
        raise ValueError("a link rate goes with the link's name")
    if resolve_device(device).type == "cuda":
        _build_kernels()
    backend = backend or default_backend(device)
    with tempfile.TemporaryDirectory(prefix="dryrun_") as work:
        ctx = mp.start_processes(
            _rank, args=(n_devices, f"{work}/rdv", f"{work}/out", device,
                         backend, timeout_s),
            nprocs=n_devices, join=False, start_method="spawn")
        procs.join_spawned(ctx, timeout_s,
                           f"the dry run of {n_devices} ranks")
        runs = []
        for r in range(n_devices):
            with open(f"{work}/out.{r}") as f:
                runs.append(json.load(f))
    res = runs[0]
    losses = res["ist_round_losses"] + [res[f"{k}_loss"]
                                        for k in ("sage", "gcn", "gat")]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite loss in the dry run: {res}")
    if any(r != res for r in runs[1:]):
        raise RuntimeError("the ranks of the dry run disagree")
    cs = res["comm"]
    print(f"dryrun_multichip({n_devices}) on {device} over {backend}: "
          f"interior tiles {res['interior_tiles']}")
    print(f"dryrun_multichip({n_devices}): IST round ok, losses="
          f"{res['ist_round_losses'][:4]}")
    print(f"dryrun_multichip({n_devices}): graph-sharded steps ok, loss "
          f"sage={res['sage_loss']:.4f} gcn={res['gcn_loss']:.4f} "
          f"gat={res['gat_loss']:.4f}")
    print(f"  halo rows/step: ideal {cs['ideal_rows']}, ring "
          f"{cs['ring_rows']} (waste {cs['ring_waste']:.2f}x), a2a "
          f"{cs['a2a_rows']} (waste {cs['a2a_waste']:.2f}x); ring shifts "
          f"kept {res['ring_shifts'][0]}/{res['ring_shifts'][1]}")
    if link_bytes_per_s is not None:
        p = res["projection"] = projection(n_devices, link_bytes_per_s,
                                           link_name, t1_ms)
        print(f"  projected scaling @D={n_devices}: edge balance "
              f"{p['edge_balance']:.2f}x, wire "
              f"{p['wire_bytes_per_device']} B/dev, efficiency "
              f"{p['efficiency_overlap']:.1%} (overlap) / "
              f"{p['efficiency_serial']:.1%} (serial) / "
              f"{p['efficiency_overlap_bf16_halo']:.1%} (bf16 halos) "
              f"[t1_agg={p['t1_ms']:.3f} ms from {p['t1_source']}; link "
              f"{link_name} at {link_bytes_per_s:.4g} B/s]")
    return res


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description="multi-rank dry run")
    p.add_argument("n_devices", type=int, nargs="?",
                   default=int(os.environ.get("DRYRUN_DEVICES", "8")))
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None)
    p.add_argument("--link-bytes-per-s", type=float, default=None,
                   help="a link rate, bytes/s: adds the projection")
    p.add_argument("--link-name", default=None,
                   help="what link that rate is (needed with the rate)")
    p.add_argument("--t1-ms", type=float, default=None,
                   help="one-device aggregation ms (default: the sharded "
                        "D=1 time in results/torch_sharded.json)")
    a = p.parse_args()
    if (a.link_bytes_per_s is None) != (a.link_name is None):
        p.error("--link-bytes-per-s and --link-name go together")
    dryrun_multichip(a.n_devices, a.device, a.backend,
                     link_bytes_per_s=a.link_bytes_per_s,
                     link_name=a.link_name, t1_ms=a.t1_ms)
