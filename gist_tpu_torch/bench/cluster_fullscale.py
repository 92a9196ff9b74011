"""The full-scale Cluster-GCN baseline on synth-amazon2m
(``benchmarks/amazon_cluster_fullscale.sh``): one in-process
``cli.cluster_gcn.main`` call with that script's flags.

    python -m gist_tpu_torch.bench.cluster_fullscale [--n-epochs 60]
        [--eval-every 5] [--dataset synth-amazon2m] [--psize 15000]
        [--cache-dir data] [--device cuda|cpu]
        [--out results/torch_amazon_cluster_baseline.json]

The flags: psize 15000, batch 10, SAGE h512 with 4 layers, dropout 0.2,
weight decay 0, lr 0.01, ``--normalize --use-f1 --use-layernorm-flag
--eval-cpu --scan-batches`` (each epoch's steps one CUDA-graph replay on
the card); ``--n-epochs`` (the script's ``EPOCHS``, 60) and
``--eval-every`` (its ``EVAL_EVERY``, 5).  The CLI's result record goes
to ``--out`` with ``power_limit_w`` and ``kernel_launches`` added, and
is printed as one JSON line.
"""

from __future__ import annotations

import argparse

from gist_tpu_torch.bench import common

DEFAULT_OUT = common.results_path("amazon_cluster_baseline")


def cli_argv(*, dataset: str = "synth-amazon2m", n_epochs: int = 60,
             eval_every: int = 5, psize: int = 15000, batch_size: int = 10,
             cache_dir: str = "data", device: str = "cuda",
             eval_cpu: bool = True, n_hidden: int = 512) -> list:
    """``cli.cluster_gcn``'s arguments as the JAX script passes them
    (``eval_cpu=False`` leaves out ``--eval-cpu``: the eval then runs on
    the card, for a caller that checks the training; ``n_hidden``
    narrows the model for a small test)."""
    argv = ["--dataset", dataset, "--psize", str(psize), "--batch-size",
            str(batch_size), "--n-hidden", str(n_hidden), "--n-layers", "4",
            "--dropout", "0.2", "--weight-decay", "0", "--lr", "0.01",
            "--n-epochs", str(n_epochs), "--normalize", "--use-f1",
            "--use-layernorm-flag", *(["--eval-cpu"] if eval_cpu else []),
            "--eval-every", str(eval_every), "--scan-batches",
            "--device", device]
    return argv + (["--cache-dir", cache_dir] if cache_dir else [])


def run(**kw) -> dict:
    """``cli.cluster_gcn.main(cli_argv(**kw))``'s record, with the card's
    power limit and the run's kernel launches."""
    from gist_tpu_torch.cli import cluster_gcn
    before = common.launch_counts()
    res = cluster_gcn.main(cli_argv(**kw))
    return {**res, **common.hardware(kw.get("device", "cuda")),
            "kernel_launches": common.launches_since(before)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-epochs", type=int, default=60)
    p.add_argument("--eval-every", type=int, default=5)
    p.add_argument("--dataset", default="synth-amazon2m")
    p.add_argument("--psize", type=int, default=15000)
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--cache-dir", default="data",
                   help="partition cache directory ('' = none)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)

    def go():
        rec = run(dataset=args.dataset, n_epochs=args.n_epochs,
                  eval_every=args.eval_every, psize=args.psize,
                  batch_size=args.batch_size, cache_dir=args.cache_dir,
                  device=args.device)
        common.write_json(args.out, rec)
        return rec

    return common.script_main(go)


if __name__ == "__main__":
    raise SystemExit(main())
