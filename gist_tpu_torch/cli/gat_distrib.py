"""Distributed GAT-GIST CLI (``gist_tpu/cli/gat_distrib.py``): the
multi-head GAT trained with GIST over Cluster-GCN batches; on the card
its batches above ``sampler.TILES_MIN_EDGES`` edges run K4-K6.

    python -m gist_tpu_torch.cli.gat_distrib --dataset synth-tiny \
        --n-hidden 16 --iter_per_site 2 --psize 4 --batch-size 2 \
        --n-epochs 4 [--device cpu]
"""

import argparse

from gist_tpu_torch.cli.common import add_common_args, apply_backend
from gist_tpu_torch.data import load_dataset
from gist_tpu_torch.models import gat
from gist_tpu_torch.train.common import TrainConfig, write_results
from gist_tpu_torch.train.ist_cluster import train_ist_cluster


def main(argv=None):
    p = argparse.ArgumentParser(description="Distributed GAT-GIST")
    add_common_args(p)
    p.add_argument("--iter_per_site", type=int, default=500)
    p.add_argument("--num_subnet", type=int, default=2)
    p.add_argument("--n-heads", type=int, default=2)
    p.add_argument("--psize", type=int, default=1500)
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--use-f1", action="store_true")
    p.add_argument("--cache-dir", type=str, default=None)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="model compute dtype")
    args = p.parse_args(argv)
    device = apply_backend(args)

    ds = load_dataset(args.dataset)
    print(ds.summary())
    cfg = gat.GATConfig(
        in_feats=ds.in_feats, n_hidden=args.n_hidden, n_classes=ds.n_classes,
        n_layers=max(args.n_layers, 2), n_heads=args.n_heads,
        dtype=args.dtype)
    tc = TrainConfig(lr=args.lr, weight_decay=args.weight_decay,
                     n_epochs=args.n_epochs, seed=args.rnd_seed,
                     num_subnet=args.num_subnet,
                     iter_per_site=args.iter_per_site)
    results = train_ist_cluster(
        ds, cfg, tc, psize=args.psize, batch_size=args.batch_size,
        use_f1=args.use_f1, normalize=args.normalize,
        cache_dir=args.cache_dir, model=gat, kind="gat", device=device)
    write_results(results, args.result_json)
    return results


if __name__ == "__main__":
    main()
