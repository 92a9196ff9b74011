"""Sweep CLI (``gist_tpu/sweeps/run.py``):

    python -m gist_tpu_torch.sweeps.run --sweep reddit-baseline \
        [--dataset synth-tiny] [--limit 1] [--out r.jsonl] [--device cpu]

Each config goes to the port's trainer that the JAX package's
``_run_one`` picks for it; the Cluster-GCN configs train with
``scan_batches=True`` (one CUDA-graph replay an epoch on a card).  The
JAX package's ``--cpu-mesh`` becomes ``--device``: the configs with
``num_subnet > 1`` run the port's single-card IST trainers, which take
no mesh.  Results append to a JSONL file that ``SweepRunner`` resumes
from and ``summarize`` and :mod:`gist_tpu_torch.plotting` read.
"""

from __future__ import annotations

import argparse
import functools
import json


def _run_one(*, dataset, trial=0, n_hidden=256, n_layers=2, lr=1e-2,
             dropout=0.2, n_epochs=40, weight_decay=0.0, num_subnet=1,
             iter_per_site=None, psize=None, batch_size=20,
             split_output=False, n_heads=None, ultra_wide=False,
             lsgd=False, device="cuda"):
    """Dispatch a single config to the right trainer on ``device``."""
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.train.common import TrainConfig

    ds = load_dataset(dataset)
    tc = TrainConfig(lr=lr, weight_decay=weight_decay, n_epochs=n_epochs,
                     seed=trial, num_subnet=num_subnet,
                     iter_per_site=iter_per_site or 5,
                     split_output=split_output)

    if n_heads is not None:
        from gist_tpu_torch.models import gat
        from gist_tpu_torch.train.ist_cluster import train_ist_cluster
        cfg = gat.GATConfig(ds.in_feats, n_hidden, ds.n_classes,
                            n_layers=max(n_layers, 2), n_heads=n_heads)
        return train_ist_cluster(ds, cfg, tc, psize=psize or 1500,
                                 batch_size=batch_size, model=gat,
                                 kind="gat", device=device, verbose=False)
    if psize is not None:
        from gist_tpu_torch.models import sage
        cfg = sage.SAGEConfig(ds.in_feats, n_hidden, ds.n_classes,
                              n_layers=n_layers, dropout=dropout)
        if ultra_wide:
            from gist_tpu_torch.train.ist_ultrawide import train_ist_ultrawide
            return train_ist_ultrawide(ds, cfg, tc, psize=psize,
                                       batch_size=batch_size, device=device,
                                       verbose=False)
        if num_subnet > 1 or lsgd:
            from gist_tpu_torch.train.ist_cluster import train_ist_cluster
            return train_ist_cluster(ds, cfg, tc, psize=psize,
                                     batch_size=batch_size, lsgd=lsgd,
                                     device=device, verbose=False)
        from gist_tpu_torch.train.cluster import train_cluster_gcn
        return train_cluster_gcn(ds, cfg, tc, psize=psize,
                                 batch_size=batch_size, scan_batches=True,
                                 device=device, verbose=False)
    # full-graph small datasets
    from gist_tpu_torch.models import gcn
    cfg = gcn.GCNConfig(ds.in_feats, n_hidden, ds.n_classes,
                        n_layers=n_layers, dropout=dropout)
    if num_subnet > 1:
        from gist_tpu_torch.ist.simulate import train_ist_simulation
        return train_ist_simulation(ds, cfg, tc, device=device,
                                    verbose=False)
    from gist_tpu_torch.train.full_graph import train_full_graph
    return train_full_graph(ds, cfg, tc, device=device, verbose=False)


def main(argv=None):
    from gist_tpu_torch.sweeps.configs import SWEEPS
    from gist_tpu_torch.sweeps.runner import SweepRunner, summarize
    from gist_tpu_torch.utils import resolve_device

    p = argparse.ArgumentParser(description="gist_tpu_torch sweep runner")
    p.add_argument("--sweep", required=True, choices=sorted(SWEEPS))
    p.add_argument("--dataset", type=str, default=None,
                   help="override the sweep's default dataset")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--trials", type=int, default=1)
    p.add_argument("--limit", type=int, default=None,
                   help="run only the first N configs")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on; 'cpu' runs every kernel's "
                        "plain PyTorch version")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    configs = SWEEPS[args.sweep](**({"dataset": args.dataset}
                                    if args.dataset else {}))
    configs = list(configs)
    if args.limit:
        configs = configs[:args.limit]
    out = args.out or f"results/{args.sweep}.jsonl"
    runner = SweepRunner(functools.partial(_run_one, device=device), out,
                         trials=args.trials)
    records = runner.run(configs)
    rows = summarize(out)
    for row in rows[:10]:
        print(json.dumps(row, default=float))
    return records, rows


if __name__ == "__main__":
    main()
