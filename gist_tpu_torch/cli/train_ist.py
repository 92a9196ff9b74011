"""Single-device IST CLI, the GIST simulation
(``gist_tpu/cli/train_ist.py``, the reference's ``gcn/train_ist.py``).

    python -m gist_tpu_torch.cli.train_ist --dataset synth-tiny \
        --n-epochs 8 --n-hidden 16 --num_subnet 2 --iter_per_site 4 \
        [--fused] [--device cpu]

The flags keep the reference's spellings, string booleans included
(``--split_input True``).  ``--use_random_proj True`` projects the
features to the widest width that ``--num_subnet`` divides.  The K
sub-GCNs train on the full graph, which carries no layout: every step
takes the segment path.
"""

import argparse

from gist_tpu_torch.cli.common import add_common_args, apply_backend, str2bool
from gist_tpu_torch.data import load_dataset
from gist_tpu_torch.ist.simulate import train_ist_simulation
from gist_tpu_torch.models import gcn
from gist_tpu_torch.train.common import TrainConfig, write_results


def main(argv=None):
    p = argparse.ArgumentParser(description="GIST simulation")
    add_common_args(p)
    p.add_argument("--use_ist", type=str, default="True")
    p.add_argument("--iter_per_site", type=int, default=5)
    p.add_argument("--num_subnet", type=int, default=2)
    p.add_argument("--split_output", type=str, default="False")
    p.add_argument("--split_input", type=str, default="True")
    p.add_argument("--self_loop", type=str, default="True")
    p.add_argument("--use_random_proj", type=str, default="True")
    p.add_argument("--fused", action="store_true",
                   help="report one loss and one eval per IST round "
                        "instead of per epoch")
    args = p.parse_args(argv)
    device = apply_backend(args)
    if not str2bool(args.use_ist):
        raise ValueError("train_ist trains with IST: --use_ist True")

    ds = load_dataset(args.dataset, args.data_root,
                      self_loop=str2bool(args.self_loop))
    if str2bool(args.use_random_proj):
        # densify and make the width divisible by num_subnet
        n_comp = (ds.in_feats // args.num_subnet) * args.num_subnet
        ds.random_projection(n_comp, seed=args.rnd_seed)
    print(ds.summary())

    cfg = gcn.GCNConfig(
        in_feats=ds.in_feats, n_hidden=args.n_hidden, n_classes=ds.n_classes,
        n_layers=args.n_layers, dropout=args.dropout,
        use_layernorm=str2bool(args.use_layernorm))
    tc = TrainConfig(
        lr=args.lr, weight_decay=args.weight_decay, n_epochs=args.n_epochs,
        seed=args.rnd_seed, num_subnet=args.num_subnet,
        iter_per_site=args.iter_per_site,
        split_input=str2bool(args.split_input),
        split_output=str2bool(args.split_output))
    results = train_ist_simulation(ds, cfg, tc, fused=args.fused,
                                   device=device)
    write_results(results, args.result_json)
    return results


if __name__ == "__main__":
    main()
