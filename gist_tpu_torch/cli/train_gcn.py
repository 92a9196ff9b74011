"""Full-graph GCN baseline CLI (``gist_tpu/cli/train_gcn.py``).

    python -m gist_tpu_torch.cli.train_gcn --dataset synth-tiny \
        --n-epochs 10 --n-hidden 16 [--profile-dir DIR] [--device cpu]

``--profile-dir`` writes a ``torch.profiler`` Chrome trace of the run
there; ``--scan-epochs k`` runs the epochs in blocks of k, each block k
replays of one captured epoch on a card (``train_full_graph``).
"""

import argparse

from gist_tpu_torch.cli.common import add_common_args, apply_backend, str2bool
from gist_tpu_torch.data import load_dataset
from gist_tpu_torch.models import gcn
from gist_tpu_torch.train.common import TrainConfig, write_results
from gist_tpu_torch.train.full_graph import train_full_graph
from gist_tpu_torch.utils import profile_trace


def main(argv=None):
    p = argparse.ArgumentParser(description="GCN full-graph baseline")
    add_common_args(p)
    p.add_argument("--self_loop", type=str, default="True")
    p.add_argument("--lr_scheduler", action="store_true", default=False)
    p.add_argument("--scan-epochs", type=int, default=0,
                   help="epochs per block of one host read; on a card "
                        "each epoch is one CUDA-graph replay (0: the "
                        "per-epoch loop)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler trace here")
    args = p.parse_args(argv)
    device = apply_backend(args)

    ds = load_dataset(args.dataset, args.data_root,
                      self_loop=str2bool(args.self_loop))
    print(ds.summary())
    cfg = gcn.GCNConfig(
        in_feats=ds.in_feats, n_hidden=args.n_hidden, n_classes=ds.n_classes,
        n_layers=args.n_layers, dropout=args.dropout,
        use_layernorm=str2bool(args.use_layernorm))
    tc = TrainConfig(lr=args.lr, weight_decay=args.weight_decay,
                     n_epochs=args.n_epochs, lr_schedule=args.lr_scheduler,
                     seed=args.rnd_seed)
    with profile_trace(args.profile_dir):
        results = train_full_graph(ds, cfg, tc, scan_epochs=args.scan_epochs,
                                   device=device)
    write_results(results, args.result_json)
    return results


if __name__ == "__main__":
    main()
