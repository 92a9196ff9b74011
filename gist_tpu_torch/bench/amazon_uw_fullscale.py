"""Full-scale ultra-wide GIST on synth-amazon2m, resumable by key
(``benchmarks/amazon_uw_fullscale.py``).

    python -m gist_tpu_torch.bench.amazon_uw_fullscale [--hidden 1024]
        [--k 8] [--epochs 16] [--eval-every 1] [--lr 1e-2] [--tag TAG]
        [--ckpt DIR] [--dataset synth-amazon2m] [--device cuda|cpu]
        [--out PATH]

The JAX script's configuration (its ``UW_*`` variables become the
flags): full synth-amazon2m (normalised), SAGE h in {512, 1024, 2048}
with 4 layers and dropout 0.2, K in {1, 8}, psize 15000, batch 10,
750 steps a subnet a round, local epochs ``--epochs // K``, lr 1e-2, a
full eval every ``--eval-every`` rounds.  On the card the K subnets
train one after another (``train_ist_ultrawide(sequential=True)``, the
JAX ``UW_BACKEND=tpu`` branch); the eval runs on the host, chunked above
``CHUNKED_EVAL_MIN_ELEMENTS`` (``models/sage.py:apply_chunked_host``).
The JAX default ``cpu-mesh`` backend is not carried over.

Resume by key: every eval checkpoints to ``--ckpt`` (default
``data/torch_uw_ckpt_h{H}_k{K}``) with the run's record so far, and a
rerun with the same key resumes after the newest round; the trainer
then returns the whole run's curve, the rounds a first call recorded as
it wrote them.

One JSON line: the F1 curve (``val_accs``, ``test_accs`` at
``eval_rounds``), per-round walls, the host-prep and device-sync split,
the time to each F1 (``train_time_at_eval``, summed over the rounds of
every call), ``resumed_from_round``, ``rounds_this_call``, ``config``,
the card's name and power limit, and ``kernel_launches``; default output
``results/torch_amazon_uw_fullscale_h{H}_k{K}.json`` (``--tag`` prefixes
the name), which :mod:`.uw_k1_probe` reads as its comparator at K=8.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

from gist_tpu_torch.bench import common

ROUND_KEYS = ("losses", "round_wall_s", "host_prep_s", "device_sync_s",
              "loadavg_1m", "rss_gb")
EVAL_KEYS = ("eval_rounds", "val_accs", "test_accs", "train_time_at_eval",
             "eval_wall_s")


def default_ckpt(hidden: int, k: int) -> str:
    return os.path.join("data", f"torch_uw_ckpt_h{hidden}_k{k}")


def default_out(hidden: int, k: int, tag: str = "") -> str:
    name = f"amazon_uw_fullscale_h{hidden}_k{k}"
    return common.results_path(f"{tag}_{name}" if tag else name)


def run(ds, device, *, hidden: int = 1024, k: int = 8, epochs: int = 16,
        eval_every: int = 1, lr: float = 1e-2, psize: int = 15000,
        batch_size: int = 10, iter_per_site: int = 750,
        dropout: float = 0.2, ckpt=None, cache_dir=None,
        init_params=None, eval_on_cpu: bool = True,
        verbose: bool = True) -> dict:
    """One call of the run keyed by ``ckpt`` on ``ds`` (normalised by the
    caller): resumes after the newest checkpoint there, trains to
    ``epochs // k`` local epochs, and returns the whole run's record.
    ``eval_on_cpu=False`` evaluates on the card instead of the host (a
    caller that checks the resume, not the eval)."""
    from gist_tpu_torch.models import sage
    from gist_tpu_torch.train.checkpoint import latest_round_dir
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.ist_ultrawide import train_ist_ultrawide
    cfg = sage.SAGEConfig(ds.in_feats, hidden, ds.n_classes, n_layers=4,
                          dropout=dropout)
    tc = TrainConfig(lr=lr, weight_decay=0.0, n_epochs=epochs,
                     num_subnet=k, iter_per_site=iter_per_site)
    last = latest_round_dir(ckpt) if ckpt else None
    start = 0 if last is None else int(
        os.path.basename(last).split("_")[1]) + 1
    before = common.launch_counts()
    t0 = time.time()
    res = train_ist_ultrawide(ds, cfg, tc, psize=psize,
                              batch_size=batch_size, use_f1=True,
                              cache_dir=cache_dir,
                              eval_every_rounds=eval_every,
                              checkpoint_dir=ckpt, sequential=True,
                              init_params=init_params,
                              eval_on_cpu=eval_on_cpu, device=device,
                              verbose=verbose)
    wall = time.time() - t0
    n_rounds = len(res["round_wall_s"])
    rec = {
        "dataset": ds.name, "num_subnet": k, "n_rounds": n_rounds,
        "resumed_from_round": start, "rounds_this_call": n_rounds - start,
        **{key: res[key] for key in ROUND_KEYS + EVAL_KEYS},
        "train_time": res["train_time"],
        "best_val": res["best_val"], "last_val": res["last_val"],
        "call_wall_s": wall, **common.hardware(device),
        "config": {"n_hidden": hidden, "n_layers": 4, "num_subnet": k,
                   "psize": psize, "batch_size": batch_size,
                   "iter_per_site": iter_per_site, "n_epochs": epochs,
                   "eval_every_rounds": eval_every, "lr": lr,
                   "dropout": dropout, "mode": "sequential subnets"},
        "kernel_launches": common.launches_since(before)}
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hidden", type=int, default=1024,
                   help="full width (JAX UW_HIDDEN: 512, 1024 or 2048)")
    p.add_argument("--k", type=int, default=8, help="subnets (JAX UW_K)")
    p.add_argument("--epochs", type=int, default=16,
                   help="total epochs; local epochs = epochs // K "
                        "(JAX UW_EPOCHS)")
    p.add_argument("--eval-every", type=int, default=1,
                   help="rounds between full evals (JAX UW_EVAL_EVERY)")
    p.add_argument("--lr", type=float, default=1e-2, help="JAX UW_LR")
    p.add_argument("--tag", default="", help="output name prefix")
    p.add_argument("--ckpt", default=None,
                   help="default data/torch_uw_ckpt_h{H}_k{K}")
    p.add_argument("--dataset", default="synth-amazon2m")
    p.add_argument("--psize", type=int, default=15000)
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--iter-per-site", type=int, default=750)
    p.add_argument("--cache-dir", default="data",
                   help="partition cache directory ('' = none)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    def go():
        from gist_tpu_torch.data import load_dataset
        from gist_tpu_torch.utils import resolve_device
        dev = resolve_device(args.device)
        ds = dataclasses.replace(load_dataset(args.dataset))
        ds.normalize_features()
        rec = run(ds, dev, hidden=args.hidden, k=args.k, epochs=args.epochs,
                  eval_every=args.eval_every, lr=args.lr, psize=args.psize,
                  batch_size=args.batch_size,
                  iter_per_site=args.iter_per_site,
                  ckpt=args.ckpt or default_ckpt(args.hidden, args.k),
                  cache_dir=args.cache_dir or None)
        common.write_json(args.out or default_out(args.hidden, args.k,
                                                  args.tag), rec)
        return rec

    return common.script_main(go)


if __name__ == "__main__":
    raise SystemExit(main())
