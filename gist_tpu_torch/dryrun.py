"""Multi-rank dry run (``__graft_entry__.dryrun_multichip``): N ranks,
spawned here, each run one IST round over a ``subnet`` mesh of all
ranks and one graph-sharded training step of SAGE, GCN and GAT over a
``graph`` mesh, on synth-tiny.

    python -m gist_tpu_torch.dryrun 8 [--device cpu] [--backend gloo]

The ranks run on the card (rank r on ``cuda:r % device_count``, the
kernels built here before any rank starts) unless ``--device cpu`` asks
for the CPU.  The backend defaults to ``nccl`` on the card and ``gloo``
on the CPU; NCCL refuses two ranks of one communicator on one card, so
several ranks sharing one card need ``--backend gloo``.  It checks the
plumbing only (finite losses, the same results on every rank); parity
with the JAX package is the tests' job.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional


def _rank(rank: int, n: int, rdv: str, out: str, device: str,
          backend: str) -> None:
    import json

    import numpy as np
    import torch
    import torch.distributed as dist

    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.ist.distributed import (build_ist_round,
                                                make_subnet_mesh)
    from gist_tpu_torch.ist.partition import boundary_sizes, sample_boundaries
    from gist_tpu_torch.models import gat, gcn, sage
    from gist_tpu_torch.parallel import build_sharded_graph, comm
    from gist_tpu_torch.parallel.graph_shard import shard_features, shard_rows
    from gist_tpu_torch.parallel.train import build_sharded_step

    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    if backend == "nccl":
        comm.rank_device(device)
    dist.init_process_group(backend, init_method=f"file://{rdv}", rank=rank,
                            world_size=n)
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


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: Optional[str] = None) -> dict:
    """Spawn ``n_devices`` ranks on ``device`` (``backend`` defaults to
    ``nccl`` on the card and ``gloo`` on the CPU), run the dry run,
    print rank 0's summary and return it; raises if a loss is not
    finite or the ranks disagree."""
    import json
    import math

    import torch.multiprocessing as mp

    from gist_tpu_torch.parallel.comm import default_backend
    from gist_tpu_torch.utils import resolve_device
    if resolve_device(device).type == "cuda":
        _build_kernels()
    backend = backend or default_backend(device)
    with tempfile.TemporaryDirectory(prefix="dryrun_") as work:
        mp.start_processes(_rank, args=(n_devices, f"{work}/rdv",
                                        f"{work}/out", device, backend),
                           nprocs=n_devices, start_method="spawn")
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
    return res


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description="multi-rank dry run")
    p.add_argument("n_devices", type=int, nargs="?",
                   default=int(os.environ.get("DRYRUN_DEVICES", "8")))
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None)
    a = p.parse_args()
    dryrun_multichip(a.n_devices, a.device, a.backend)
