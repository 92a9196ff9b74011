"""The round-2 result records (``benchmarks/record_r2.py``): the
single-run baselines and the ultra-wide grid, each trained once and
written to ``results/torch_<name>.json``.

    python -m gist_tpu_torch.bench.record_r2 [singles|ultrawide|
        ultrawide:H,K|all] [--only NAME ...] [--n-epochs N]
        [--device cuda|cpu] [--out results]

The JAX script's runs and hyperparameters (:data:`SINGLES`,
:func:`ultrawide_runs`):

* ``singles``: cora GCN h256 (1 hidden layer, dropout 0.5; lr 1e-2,
  weight decay 5e-4, 400 epochs, the LR schedule, ``scan_epochs=50``);
  reddit-small full-graph SAGE h256 (2 hidden layers, dropout 0.2) in
  fp32 and bf16 (lr 1e-2, weight decay 0, 60 epochs,
  ``scan_epochs=20``), features normalised; the reddit Cluster-GCN
  baseline, SAGE h256 (lr 3e-2, 40 epochs, psize 1500, batch 20,
  micro-F1, ``scan_batches=True``);
* ``ultrawide``: ultra-wide SAGE (2 hidden layers, dropout 0.2) on
  synth-amazon2m-small, normalised, at (h, K) = (512, 8), (1024, 8),
  (2048, 8) and (2048, 1): lr 1e-2, 40 epochs, 150 steps a subnet a
  round, psize 1500, batch 10, micro-F1, an eval every 2 rounds;
  ``ultrawide:H,K`` runs that one point (any H and K).

On the card every K runs sequentially on the one card
(``train_ist_ultrawide(sequential=True)``, the flagship's mode; the JAX
docstring's 8-device CPU mesh does not apply), its eval on the host as
in JAX.  The full-graph and Cluster-GCN runs take K1 through the
trainers' own layouts.

``--only`` keeps the named runs (``cora_gcn``, ``reddit_full_float32``,
``reddit_full_bfloat16``, ``reddit_cluster_baseline``, ``uw_h{H}_k{K}``)
and ``--n-epochs`` sets every run's epochs: a cut run, for a smoke test.
Each record holds the trainer's result (the JAX keys) and
``wall_time``, plus ``config``, the card's name and power limit and
``kernel_launches``; one JSON line a run, and a last one naming the
runs recorded.  The first run that fails stops the script: one
``"error"`` line, exit 1, nothing written for that run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from gist_tpu_torch.bench import common

# (name, dataset, normalise, trainer, model, model config, TrainConfig,
# trainer keywords): the JAX script's singles, in its order
SINGLES = (
    ("cora_gcn", "synth-cora", False, "full_graph", "gcn",
     dict(n_hidden=256, n_layers=1, dropout=0.5),
     dict(lr=1e-2, weight_decay=5e-4, n_epochs=400, lr_schedule=True),
     dict(scan_epochs=50)),
    ("reddit_full_float32", "synth-reddit-small", True, "full_graph", "sage",
     dict(n_hidden=256, n_layers=2, dropout=0.2, dtype="float32"),
     dict(lr=1e-2, weight_decay=0.0, n_epochs=60), dict(scan_epochs=20)),
    ("reddit_full_bfloat16", "synth-reddit-small", True, "full_graph",
     "sage", dict(n_hidden=256, n_layers=2, dropout=0.2, dtype="bfloat16"),
     dict(lr=1e-2, weight_decay=0.0, n_epochs=60), dict(scan_epochs=20)),
    ("reddit_cluster_baseline", "synth-reddit-small", True, "cluster",
     "sage", dict(n_hidden=256, n_layers=2, dropout=0.2),
     dict(lr=3e-2, weight_decay=0.0, n_epochs=40),
     dict(psize=1500, batch_size=20, use_f1=True, scan_batches=True)),
)
UW_GRID = ((512, 8), (1024, 8), (2048, 8), (2048, 1))
UW_DATASET = "synth-amazon2m-small"


@dataclasses.dataclass(frozen=True)
class Run:
    name: str
    dataset: str
    normalize: bool
    trainer: str          # full_graph, cluster or ultrawide
    model: str            # gcn or sage
    cfg: dict
    tc: dict
    kw: dict


def ultrawide_runs(only=None) -> list:
    """The JAX grid, or the one point ``only`` (``"H,K"``)."""
    grid = UW_GRID
    if only:
        grid = (tuple(int(v) for v in only.split(",")),)
    return [Run(f"uw_h{h}_k{k}", UW_DATASET, True, "ultrawide", "sage",
                dict(n_hidden=h, n_layers=2, dropout=0.2),
                dict(lr=1e-2, weight_decay=0.0, n_epochs=40, num_subnet=k,
                     iter_per_site=150),
                dict(psize=1500, batch_size=10, use_f1=True,
                     eval_every_rounds=2))
            for h, k in grid]


def runs(what: str = "all") -> list:
    """The runs of a mode, in the JAX script's order."""
    out = []
    if what in ("singles", "all"):
        out += [Run(*spec) for spec in SINGLES]
    if what.startswith("ultrawide:"):
        out += ultrawide_runs(what.split(":", 1)[1])
    elif what in ("ultrawide", "all"):
        out += ultrawide_runs()
    if not out:
        raise ValueError(f"mode {what!r}: singles, ultrawide, ultrawide:H,K "
                         f"or all")
    return out


def configs(run: Run, ds, n_epochs=None, dropout=None):
    """(model module, its config, TrainConfig) of ``run`` on ``ds``;
    ``n_epochs`` and ``dropout`` replace the run's where given."""
    from gist_tpu_torch.models import gcn, sage
    from gist_tpu_torch.train.common import TrainConfig
    model = {"gcn": gcn, "sage": sage}[run.model]
    cls = gcn.GCNConfig if run.model == "gcn" else sage.SAGEConfig
    cfg_kw = dict(run.cfg)
    if dropout is not None:
        cfg_kw["dropout"] = dropout
    tc_kw = dict(run.tc)
    if n_epochs is not None:
        tc_kw["n_epochs"] = n_epochs
    return (model, cls(ds.in_feats, n_classes=ds.n_classes, **cfg_kw),
            TrainConfig(**tc_kw))


def train(run: Run, ds, device, *, n_epochs=None, dropout=None,
          init_params=None, cache_dir=None, verbose: bool = False) -> dict:
    """``run``'s trainer on ``ds`` (normalised by the caller where the run
    says so): the trainer's result plus ``wall_time``, ``config``, the
    card's stamp and ``kernel_launches``.  ``cache_dir`` caches the
    Cluster-GCN and ultra-wide runs' partitions (the JAX script keeps
    none)."""
    from gist_tpu_torch.train.cluster import train_cluster_gcn
    from gist_tpu_torch.train.full_graph import train_full_graph
    from gist_tpu_torch.train.ist_ultrawide import train_ist_ultrawide
    model, cfg, tc = configs(run, ds, n_epochs, dropout)
    before = common.launch_counts()
    t0 = time.time()
    if run.trainer == "full_graph":
        res = train_full_graph(ds, cfg, tc, model=model, device=device,
                               init_params=init_params, verbose=verbose,
                               **run.kw)
    elif run.trainer == "cluster":
        res = train_cluster_gcn(ds, cfg, tc, model=model, device=device,
                                init_params=init_params, verbose=verbose,
                                cache_dir=cache_dir, **run.kw)
    else:
        res = train_ist_ultrawide(ds, cfg, tc, model=model, sequential=True,
                                  device=device, init_params=init_params,
                                  verbose=verbose, cache_dir=cache_dir,
                                  **run.kw)
    res["wall_time"] = time.time() - t0
    res["config"] = {"dataset": run.dataset, "normalize": run.normalize,
                     "trainer": run.trainer, "model": run.model,
                     **dataclasses.asdict(cfg),
                     **{f"tc_{k}": v for k, v in
                        dataclasses.asdict(tc).items()},
                     **run.kw}
    res.update(common.hardware(device))
    res["kernel_launches"] = common.launches_since(before)
    return res


def record(what: str = "all", device="cuda", *, only=None, n_epochs=None,
           out_dir: str = "results", cache_dir=None) -> dict:
    """Train every run of ``what`` (those named in ``only``) in order,
    writing each record to ``out_dir/torch_r2_<name>.json`` as it ends;
    returns ``{name: record}``.  A run that raises stops the rest.
    ``cache_dir``: as :func:`train`'s."""
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.utils import resolve_device
    dev = resolve_device(device)
    todo = runs(what)
    if only:
        unknown = set(only) - {r.name for r in todo}
        if unknown:
            raise ValueError(f"no run named {sorted(unknown)} in {what!r}")
        todo = [r for r in todo if r.name in only]
    loaded, out = {}, {}
    for run in todo:
        key = (run.dataset, run.normalize)
        if key not in loaded:
            ds = dataclasses.replace(load_dataset(run.dataset))
            if run.normalize:
                ds.normalize_features()
            loaded[key] = ds
        # the trainers may normalise or cache on the dataset: each run
        # gets its own copy of the fields
        res = train(run, dataclasses.replace(loaded[key]), dev,
                    n_epochs=n_epochs, cache_dir=cache_dir)
        path = os.path.join(out_dir, f"torch_r2_{run.name}.json")
        common.write_json(path, res)
        print(json.dumps({"run": f"r2_{run.name}", "path": path, **{
            k: res[k] for k in ("best_val_acc", "best_test_acc", "kteps",
                                "train_time", "best_val", "best_test",
                                "wall_time", "kernel_launches")
            if k in res}}), flush=True)
        out[run.name] = res
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("what", nargs="?", default="all",
                   help="singles, ultrawide, ultrawide:H,K or all")
    p.add_argument("--only", nargs="+", default=None,
                   help="run only these names (e.g. reddit_full_float32)")
    p.add_argument("--n-epochs", type=int, default=None,
                   help="every run's epochs (default: the JAX script's)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="results",
                   help="directory of the records")
    args = p.parse_args(argv)
    return common.script_main(lambda: {"recorded": sorted(record(
        args.what, args.device, only=args.only, n_epochs=args.n_epochs,
        out_dir=args.out))})


if __name__ == "__main__":
    raise SystemExit(main())
