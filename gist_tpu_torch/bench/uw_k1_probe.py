"""The K=1 ultra-wide control's full-width step rate over short bursts,
and the projected budget-matched run (``benchmarks/uw_k1_probe.py``).

    python -m gist_tpu_torch.bench.uw_k1_probe [--hidden 2048] [--steps 50]
        [--rounds 3] [--budget-epochs N] [--comparator PATH]
        [--dataset synth-amazon2m] [--device cuda|cpu] [--out PATH]

The JAX script's configuration: full synth-amazon2m (normalised), SAGE
with 4 layers and dropout 0.2, K=1, psize 15000, batch 10, a burst of
``--steps`` (its ``PROBE_STEPS``, 50) steps a round, 3 rounds (the first
warms up, the others are steady).  On the card the burst is the
sequential one (``ist/ultrawide.py:build_local_burst_single``), the JAX
``UW_BACKEND=tpu`` branch; the full-width model stays in host numpy.

Each round's wall is split into the burst (timed alone, between two
synchronisations) and the fixed work around it: dispatch, the copy to
the card, the copy back and the merge.  The batch collection is left
out, as the trainer overlaps it with the burst.  The projection
(:func:`projection`) is ``round750_s = fixed_s + 750 * s_per_step``,
``s_per_step`` the least steady burst over ``--steps`` and ``fixed_s``
the median fixed wall, times the rounds a K=1 run of the budget needs.
The budget comes from the port's own K=8 comparator,
``results/torch_amazon_uw_fullscale_h{H}_k8.json`` (``config.n_epochs``,
written by :mod:`.amazon_uw_fullscale`), else 40 epochs, as in JAX;
``--budget-epochs`` overrides it.  Each round's padded bucket shapes are
recorded, so a round whose shapes moved can be told apart.

One JSON line with the JAX keys plus ``power_limit_w``, ``losses`` and
``kernel_launches``; default output ``results/torch_uw_k1_probe_h{H}.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import resource
import statistics
import time

import numpy as np
import torch

from gist_tpu_torch.bench import common

ITER_PER_SITE = 750       # the comparator family's round length
DEFAULT_BUDGET = 40
K = 1


def comparator_path(hidden: int) -> str:
    return common.results_path(f"amazon_uw_fullscale_h{hidden}_k8")


def comparator_budget(path: str):
    """The comparator record's ``config.n_epochs``, None without one."""
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as fh:
        return json.load(fh).get("config", {}).get("n_epochs")


def projection(fixed_walls, burst_walls, steps: int, steps_per_epoch: int,
               budget_epochs: int, iter_per_site: int = ITER_PER_SITE
               ) -> dict:
    """The JAX probe's projection: ``s_per_step`` the least steady burst
    (every round but the first) over ``steps``, ``fixed_s`` the median
    fixed wall, ``round750_s = fixed_s + iter_per_site * s_per_step``;
    K=1 runs ``budget_epochs`` local epochs, so
    ``budget_epochs * steps_per_epoch // iter_per_site`` rounds (at
    least one)."""
    s_per_step = min(burst_walls[1:]) / steps
    fixed_s = float(statistics.median(fixed_walls))
    round750_s = fixed_s + s_per_step * iter_per_site
    n_rounds = max(budget_epochs * steps_per_epoch // iter_per_site, 1)
    return {"s_per_step_full_width": s_per_step,
            "fixed_s_per_round": fixed_s,
            "projected_round750_s": round750_s,
            "n_rounds_at_budget": n_rounds,
            "projected_train_s_at_budget": round750_s * n_rounds}


def run(ds, device, *, hidden: int = 2048, steps: int = 50,
        rounds: int = 3, psize: int = 15000, batch_size: int = 10,
        budget_epochs: int = DEFAULT_BUDGET, dropout: float = 0.2,
        lr: float = 1e-2, init_params=None, cache_dir=None) -> dict:
    """The probe on ``ds`` (normalised by the caller, as the JAX script
    normalises): ``rounds`` rounds of a ``steps``-step K=1 burst at full
    width.  ``init_params`` (a numpy tree) replaces the init drawn from
    a CPU generator seeded 0.  Losses are each round's mean."""
    from gist_tpu_torch.convert import params_to_numpy
    from gist_tpu_torch.ist.partition import boundary_sizes
    from gist_tpu_torch.ist.ultrawide import (build_local_burst_single,
                                              dispatch_host, merge_host,
                                              sample_boundaries_host,
                                              subnet_generator)
    from gist_tpu_torch.models import sage
    from gist_tpu_torch.sampler import ClusterSampler
    from gist_tpu_torch.train.ist_cluster import (_batches_to_device,
                                                  _RoundCollector)
    from gist_tpu_torch.utils import draw_seed
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    before = common.launch_counts()
    cfg = sage.SAGEConfig(ds.in_feats, hidden, ds.n_classes, n_layers=4,
                          dropout=dropout)
    sampler = ClusterSampler(ds, psize, batch_size, cache_dir=cache_dir,
                             seed=0)
    tables = sampler.tables(dev)
    collector = _RoundCollector(sampler, steps, ids_only=True)
    if init_params is None:
        init_params = params_to_numpy(
            sage.init(torch.Generator().manual_seed(0), cfg))
    full = {"layers": [{k: np.array(v, dtype=np.float32, copy=True)
                        for k, v in l.items()}
                       for l in init_params["layers"]]}
    sub_cfg = cfg.sub_config(split_input=False, split_output=True,
                             num_subnet=K)
    sizes = boundary_sizes(cfg.in_feats, cfg.n_hidden, cfg.n_layers,
                           split_input=False, split_output=True)
    burst_fn = build_local_burst_single(sage, sub_cfg, weight_decay=0.0)
    host_rng = np.random.default_rng(1)
    seeds = torch.Generator().manual_seed(0)

    walls, bursts, fixed, buckets, losses = [], [], [], [], []
    for _ in range(rounds):
        t0 = time.time()
        bnds = sample_boundaries_host(host_rng, sizes, K)
        batches = _batches_to_device(collector.collect(), dev)
        buckets.append([int(batches[0].node_ids.shape[0]),
                        int(batches[0].graph.n_edges_padded)])
        tf0 = time.time()
        sub_np = dispatch_host(full, bnds, K, "sage")
        sub = {"layers": [{k: torch.tensor(v[0], device=dev)
                           for k, v in l.items()}
                          for l in sub_np["layers"]]}
        sync()
        tb0 = time.time()
        sub, rl = burst_fn(sub, batches, lr,
                           subnet_generator(draw_seed(seeds), 0, dev),
                           tables)
        sync()
        tb1 = time.time()
        trained = {"layers": [{k: v[None] for k, v in l.items()}
                              for l in params_to_numpy(sub)["layers"]]}
        losses.append(float(rl.mean()))
        full = merge_host(full, bnds, trained, K, "sage")
        t1 = time.time()
        walls.append(t1 - t0)
        bursts.append(tb1 - tb0)
        fixed.append((tb0 - tf0) + (t1 - tb1))
    return {
        "dataset": ds.name, "n_hidden": hidden, "num_subnet": K,
        "probe_steps": steps, "rounds": rounds,
        "iter_per_site": ITER_PER_SITE, **common.hardware(dev),
        "round_wall_s": walls, "burst_wall_s": bursts,
        "fixed_wall_s": fixed, "bucket_shapes": buckets,
        "steady_bucket_recompile_detected": any(
            b != buckets[0] for b in buckets[1:]),
        "losses": losses, "budget_epochs": budget_epochs,
        "steps_per_epoch": len(sampler),
        **projection(fixed, bursts, steps, len(sampler), budget_epochs),
        "rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        / 2 ** 20,
        "loadavg_1m": os.getloadavg()[0],
        "kernel_launches": common.launches_since(before),
        "params": full}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hidden", type=int, default=2048,
                   help="full width (JAX UW_HIDDEN; 1024 or 2048)")
    p.add_argument("--steps", type=int, default=50,
                   help="burst length (JAX PROBE_STEPS)")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--budget-epochs", type=int, default=None,
                   help="default: the comparator's n_epochs, else 40")
    p.add_argument("--comparator", default=None,
                   help="default results/torch_amazon_uw_fullscale_"
                        "h{H}_k8.json")
    p.add_argument("--dataset", default="synth-amazon2m")
    p.add_argument("--psize", type=int, default=15000)
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--cache-dir", default="data",
                   help="partition cache directory ('' = none)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None,
                   help="default results/torch_uw_k1_probe_h{H}.json")
    args = p.parse_args(argv)

    def go():
        from gist_tpu_torch.data import load_dataset
        from gist_tpu_torch.utils import resolve_device
        dev = resolve_device(args.device)
        cmp_path = args.comparator or comparator_path(args.hidden)
        cmp_budget = comparator_budget(cmp_path)
        budget = args.budget_epochs or cmp_budget or DEFAULT_BUDGET
        ds = dataclasses.replace(load_dataset(args.dataset))
        ds.normalize_features()
        rec = run(ds, dev, hidden=args.hidden, steps=args.steps,
                  rounds=args.rounds, psize=args.psize,
                  batch_size=args.batch_size, budget_epochs=budget,
                  cache_dir=args.cache_dir or None)
        del rec["params"]
        rec.update(comparator=cmp_path if cmp_budget is not None else None,
                   comparator_budget_epochs=cmp_budget)
        common.write_json(args.out or common.results_path(
            f"uw_k1_probe_h{args.hidden}"), rec)
        return rec

    return common.script_main(go)


if __name__ == "__main__":
    raise SystemExit(main())
