"""The ultra-wide flagship through the port's CLI on one CUDA card.

    python3 chip_flagship.py [--n-hidden 2048] [--out DIR] [--work DIR]

Runs, from the root of a checkout, the round-5 flagship configuration
(SAGE, 4 hidden layers, K=8, full synth-amazon2m, psize 15000, batch 10,
``iter_per_site`` 750, lr 5e-3, dropout 0.2, 8 epochs: 2 rounds with a
chunked host eval each) as

    python -m gist_tpu_torch.cli.ist_distrib --ultra-wide ...
        --checkpoint-dir WORK/ckpt --result-json OUT/result.json

after building the dataset and the partition into their caches in
processes of their own, so that their seconds are measured apart.  It
prints the host's ``nproc`` and ``free -g``, the card's name and power
limit, each step's seconds and, last, one JSON line with the figures of
the run.  The checkpoints (~100 MB a round at h2048) and the partition
cache go under ``--work``; a rerun with the same ``--work`` resumes from
the newest checkpoint.  Needs a card; it imports no JAX.
"""

import argparse
import json
import os
import sys
import time

from gist_tpu_torch.bench.procs import run_child

HERE = os.path.dirname(os.path.abspath(__file__))


def _run(cmd, **kw):
    t0 = time.time()
    run_child(cmd, check=True, cwd=HERE, **kw)
    return time.time() - t0


def _text(cmd):
    return run_child(cmd, 60, capture_output=True, text=True).stdout.strip()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-hidden", type=int, default=2048)
    p.add_argument("--out", type=str, default="data/flagship",
                   help="where the result record goes")
    p.add_argument("--work", type=str, default="data/flagship",
                   help="where the checkpoints and partition cache go")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_flagship: no CUDA device available")
    out, work = os.path.abspath(args.out), os.path.abspath(args.work)
    os.makedirs(out, exist_ok=True)
    cache = os.path.join(work, "partition_cache")
    host = {"nproc": int(_text(["nproc"]) or 0), "free_g": _text(["free", "-g"]),
            "card": _text(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"])}
    print(json.dumps(host), flush=True)
    dataset_s = _run([sys.executable, "-c",
                      "from gist_tpu_torch.data import load_dataset; "
                      "print(load_dataset('synth-amazon2m').summary())"])
    partition_s = _run([sys.executable, "-c",
                        "from gist_tpu_torch.data import load_dataset; "
                        "from gist_tpu_torch.sampler import ClusterSampler; "
                        "s = ClusterSampler(load_dataset('synth-amazon2m'), "
                        f"15000, 10, cache_dir={cache!r}, seed=3); "
                        "print(len(s), 'batches an epoch')"])
    print(json.dumps({"dataset_s": dataset_s, "partition_s": partition_s}),
          flush=True)
    result = os.path.join(out, "result.json")
    cli_s = _run([sys.executable, "-m", "gist_tpu_torch.cli.ist_distrib",
                  "--ultra-wide", "--dataset", "synth-amazon2m",
                  "--n-hidden", str(args.n_hidden), "--n-layers", "4",
                  "--num_subnet", "8", "--iter_per_site", "750",
                  "--psize", "15000", "--batch-size", "10", "--lr", "5e-3",
                  "--dropout", "0.2", "--weight-decay", "0",
                  "--n-epochs", "8", "--normalize", "--use-f1",
                  "--cache-dir", cache,
                  "--checkpoint-dir", os.path.join(work, "ckpt"),
                  "--result-json", result])
    r = json.load(open(result))
    keys = ("round_wall_s", "host_prep_s", "device_sync_s", "eval_wall_s",
            "rss_gb", "loadavg_1m", "val_accs", "losses", "train_time",
            "hardware")
    print(json.dumps({"n_hidden": args.n_hidden, "dataset_s": dataset_s,
                      "partition_s": partition_s, "cli_s": cli_s,
                      **host, **{k: r[k] for k in keys}}), flush=True)


if __name__ == "__main__":
    main()
