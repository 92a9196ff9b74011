"""Distributed GIST + Cluster-GCN CLI (``gist_tpu/cli/ist_distrib.py``)
and, with ``--ultra-wide``, the host-offloaded ultra-wide trainer.

    python -m gist_tpu_torch.cli.ist_distrib --dataset synth-tiny \
        --n-hidden 16 --num_subnet 2 --iter_per_site 2 --psize 4 \
        --batch-size 2 --n-epochs 8 [--ultra-wide] [--device cpu]

One process runs the K subnets one after another on one device.  With
``--checkpoint-dir`` each eval round is saved and a rerun of the same
command resumes after the newest round.  ``--use-pp`` and ``--lsgd``
reach the trainers, which raise until their slices are ported.
"""

import argparse

from gist_tpu_torch.cli.common import add_common_args, apply_backend, str2bool
from gist_tpu_torch.data import load_dataset
from gist_tpu_torch.models import sage
from gist_tpu_torch.train.common import TrainConfig, write_results
from gist_tpu_torch.train.ist_cluster import train_ist_cluster


def main(argv=None):
    p = argparse.ArgumentParser(description="Distributed GIST")
    add_common_args(p)
    p.add_argument("--iter_per_site", type=int, default=5)
    p.add_argument("--num_subnet", type=int, default=2)
    p.add_argument("--psize", type=int, default=1500)
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--use-pp", action="store_true")
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--use-f1", action="store_true")
    p.add_argument("--ultra-wide", action="store_true",
                   help="host-offload the full-width params (the "
                        "ultra-wide regime)")
    p.add_argument("--lsgd", action="store_true",
                   help="local-SGD baseline: full model per worker, "
                        "periodic averaging")
    p.add_argument("--cache-dir", type=str, default=None)
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="save params + RNG state per eval round; resume "
                        "from the latest round when present")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="model compute dtype")
    args = p.parse_args(argv)
    device = apply_backend(args)

    ds = load_dataset(args.dataset)
    print(ds.summary())
    cfg = sage.SAGEConfig(
        in_feats=ds.in_feats, n_hidden=args.n_hidden, n_classes=ds.n_classes,
        n_layers=args.n_layers, dropout=args.dropout,
        use_layernorm=str2bool(args.use_layernorm), dtype=args.dtype)
    tc = TrainConfig(lr=args.lr, weight_decay=args.weight_decay,
                     n_epochs=args.n_epochs, seed=args.rnd_seed,
                     num_subnet=args.num_subnet,
                     iter_per_site=args.iter_per_site)
    if args.ultra_wide:
        from gist_tpu_torch.train.ist_ultrawide import train_ist_ultrawide
        results = train_ist_ultrawide(
            ds, cfg, tc, psize=args.psize, batch_size=args.batch_size,
            use_pp=args.use_pp, use_f1=args.use_f1,
            normalize=args.normalize, cache_dir=args.cache_dir,
            checkpoint_dir=args.checkpoint_dir, device=device)
    else:
        results = train_ist_cluster(
            ds, cfg, tc, psize=args.psize, batch_size=args.batch_size,
            use_pp=args.use_pp, use_f1=args.use_f1, normalize=args.normalize,
            cache_dir=args.cache_dir, lsgd=args.lsgd,
            checkpoint_dir=args.checkpoint_dir, device=device)
    write_results(results, args.result_json)
    return results


if __name__ == "__main__":
    main()
