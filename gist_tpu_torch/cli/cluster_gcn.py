"""Cluster-GCN single-device CLI (``gist_tpu/cli/cluster_gcn.py``).

    python -m gist_tpu_torch.cli.cluster_gcn --dataset synth-tiny \
        --n-epochs 3 --psize 4 --batch-size 2 [--scan-batches] [--device cpu]

``--scan-batches`` stacks each epoch's batches and, on a card, replays
them as one captured CUDA graph (``train_cluster_gcn``).
"""

import argparse

from gist_tpu_torch.cli.common import add_common_args, apply_backend
from gist_tpu_torch.data import load_dataset
from gist_tpu_torch.models import sage
from gist_tpu_torch.train.cluster import train_cluster_gcn
from gist_tpu_torch.train.common import TrainConfig, write_results


def main(argv=None):
    p = argparse.ArgumentParser(description="Cluster-GCN")
    add_common_args(p)
    p.add_argument("--psize", type=int, default=1500)
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--use-pp", action="store_true")
    p.add_argument("--normalize", action="store_true")
    p.add_argument("--use-f1", action="store_true")
    p.add_argument("--use-layernorm-flag", dest="use_ln", action="store_true",
                   help="reference spelling: --use-layernorm store_true")
    p.add_argument("--model-type", type=str, default="sage")
    p.add_argument("--cache-dir", type=str, default=None)
    p.add_argument("--eval-cpu", action="store_true")
    p.add_argument("--eval-every", type=int, default=1,
                   help="full-graph eval cadence in epochs (the last "
                        "epoch always evaluates)")
    p.add_argument("--scan-batches", action="store_true",
                   help="one dispatch per epoch: the epoch's steps "
                        "replayed as one CUDA graph on a card")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="model compute dtype")
    args = p.parse_args(argv)
    device = apply_backend(args)
    if args.model_type != "sage":
        raise ValueError("only --model-type sage is supported")

    ds = load_dataset(args.dataset, args.data_root)
    print(ds.summary())
    cfg = sage.SAGEConfig(
        in_feats=ds.in_feats, n_hidden=args.n_hidden, n_classes=ds.n_classes,
        n_layers=args.n_layers, dropout=args.dropout,
        use_layernorm=args.use_ln or args.use_layernorm == "True",
        use_pp=args.use_pp, dtype=args.dtype)
    tc = TrainConfig(lr=args.lr, weight_decay=args.weight_decay,
                     n_epochs=args.n_epochs, seed=args.rnd_seed)
    results = train_cluster_gcn(
        ds, cfg, tc, psize=args.psize, batch_size=args.batch_size,
        use_pp=args.use_pp, use_f1=args.use_f1, normalize=args.normalize,
        cache_dir=args.cache_dir, eval_cpu=args.eval_cpu,
        eval_every=args.eval_every, scan_batches=args.scan_batches,
        device=device)
    write_results(results, args.result_json)
    return results


if __name__ == "__main__":
    main()
