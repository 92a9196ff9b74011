"""Accuracy-curve and sweep-tradeoff figures (``gist_tpu/plotting.py``).

The reference dumps a matplotlib validation-accuracy curve after every
run (gcn/train_ist.py:27-37, cluster_gcn/cluster_gcn.py:138-142,
cluster_gcn_ist_distrib.py:457-461) and its sweep scripts exist to
produce accuracy-vs-K / accuracy-vs-iter_per_site tradeoff tables.
Here the primary artifact is the JSON result file / sweep JSONL; this
module renders those artifacts into figures after the fact:

    # per-run curve from a --result-json file
    python -m gist_tpu_torch.plotting run results/r2_cora_gcn.json -o curve.png

    # tradeoff curves from a sweep JSONL
    python -m gist_tpu_torch.plotting sweep results/r2_reddit_ist_focus.jsonl \
        --x num_subnet --y best_test --group iter_per_site -o k_curve.png

matplotlib is imported lazily with the Agg backend so headless runs
(and the test suite) never need a display, and nothing on the training
path imports it.
"""

from __future__ import annotations

import json
from typing import Optional


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def save_run_curve(results: dict, path: str,
                   title: Optional[str] = None) -> str:
    """Validation/test accuracy (and loss, when present) vs evaluation
    index — the reference's per-run figure."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    if results.get("val_accs"):
        ax.plot(results["val_accs"], label="val", marker="o", ms=3)
    if results.get("test_accs"):
        ax.plot(results["test_accs"], label="test", marker="s", ms=3)
    ax.set_xlabel("evaluation")
    ax.set_ylabel("accuracy / micro-F1")
    if results.get("losses"):
        ax2 = ax.twinx()
        ax2.plot(results["losses"], color="gray", alpha=0.5, lw=1,
                 label="loss")
        ax2.set_ylabel("loss")
    ax.legend(loc="lower right")
    ax.set_title(title or results.get("dataset", "run"))
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def save_sweep_curves(jsonl_path: str, out_path: str, *, x: str,
                      y: str = "best_test",
                      group: Optional[str] = None) -> str:
    """One line per ``group`` value: ``y`` against ``x`` across the
    sweep's configs (e.g. best_test vs num_subnet, one line per
    iter_per_site) — the tradeoff figures the reference's sweep grids
    exist to produce."""
    plt = _plt()
    rows = []
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if row.get("status", "ok") != "ok":
                continue
            flat = {**row.get("config", {}), **row.get("result", {}),
                    **{k: v for k, v in row.items()
                       if not isinstance(v, dict)}}
            if x in flat and y in flat:
                rows.append(flat)
    if not rows:
        raise ValueError(f"no rows in {jsonl_path} with both "
                         f"{x!r} and {y!r}")
    fig, ax = plt.subplots(figsize=(6, 4))
    keys = sorted({r.get(group) for r in rows}, key=lambda v: (v is None, v)) \
        if group else [None]
    for k in keys:
        sel = [r for r in rows if group is None or r.get(group) == k]
        # aggregate trials per x cell: mean with a std error band
        # (trials >= 3 since round 3, script/baseline_sweep.py:13,25)
        cells = {}
        for r in sel:
            cells.setdefault(r[x], []).append(r[y])
        xs = sorted(cells)
        means = [sum(cells[v]) / len(cells[v]) for v in xs]
        stds = [(sum((u - m) ** 2 for u in cells[v]) / len(cells[v])) ** 0.5
                for v, m in zip(xs, means)]
        label = f"{group}={k}" if group else y
        line, = ax.plot(xs, means, marker="o", ms=4, label=label)
        if any(s > 0 for s in stds):
            ax.fill_between(xs, [m - s for m, s in zip(means, stds)],
                            [m + s for m, s in zip(means, stds)],
                            color=line.get_color(), alpha=0.15, lw=0)
    ax.set_xlabel(x)
    ax.set_ylabel(y)
    ax.legend()
    ax.set_title(jsonl_path.rsplit("/", 1)[-1])
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="render result figures")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("run", help="per-run accuracy curve")
    pr.add_argument("result_json")
    pr.add_argument("-o", "--out", default=None)
    ps = sub.add_parser("sweep", help="sweep tradeoff curves")
    ps.add_argument("jsonl")
    ps.add_argument("--x", required=True)
    ps.add_argument("--y", default="best_test")
    ps.add_argument("--group", default=None)
    ps.add_argument("-o", "--out", default=None)
    args = p.parse_args(argv)
    if args.cmd == "run":
        with open(args.result_json) as f:
            results = json.load(f)
        out = args.out or args.result_json.replace(".json", "") + ".png"
        print(save_run_curve(results, out))
    else:
        out = args.out or args.jsonl.replace(".jsonl", "") + ".png"
        print(save_sweep_curves(args.jsonl, out, x=args.x, y=args.y,
                                group=args.group))


if __name__ == "__main__":
    main()
