"""The round-4 figures (``benchmarks/r4_figures.py``) from the port's
records.

    python -m gist_tpu_torch.bench.r4_figures [--results results]

Renders what records exist and skips the rest, so it can run at any
time, and writes ``results/torch_r4_*.png``:

* ``torch_r4_ist_sharded_2d.png``: the 2-D (subnet x graph) val curve
  against its 1-D IST control, from ``torch_ist_sharded_2d.json``
  (:mod:`.ist_sharded_2d`; ``curves.2d.val``, ``curves.1d.val``);
* ``torch_r4_amazon_uw_family.png``: the ultra-wide family's val
  micro-F1 by round and by train seconds, from
  ``torch_amazon_uw_fullscale_h{512,1024,2048}_k{1,8}.json``
  (:mod:`.amazon_uw_fullscale`; ``val_accs``, ``eval_rounds``,
  ``train_time_at_eval``);
* ``torch_r4_sharded_models.png``: the graph-sharded GCN and GAT val
  curves, from ``torch_sharded_gcn_reddit.json`` and
  ``torch_sharded_gat_reddit.json`` (``cli.sharded_train
  --result-json``; ``val_accs``, ``best_val_acc``).

Titles name the card and mesh that each record gives.  Needs matplotlib,
which the card's machine does not have: run it where the records were
copied to.
"""

from __future__ import annotations

import argparse
import json
import os


def plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as pyplot
    return pyplot


def load(results: str, name: str):
    """The record ``results/name``, None where there is none."""
    path = os.path.join(results, name)
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def save(fig, results: str, name: str) -> str:
    fig.tight_layout()
    path = os.path.join(results, name)
    fig.savefig(path, dpi=120)
    plt().close(fig)
    print(f"wrote {path}", flush=True)
    return path


def mesh_name(d: dict) -> str:
    s, g = d.get("mesh", ("?", "?"))
    return f"subnet={s} x graph={g}"


def fig_2d(results: str):
    d = load(results, "torch_ist_sharded_2d.json")
    if d is None:
        return None
    fig, ax = plt().subplots(figsize=(5.5, 3.5))
    rounds = range(len(d["curves"]["2d"]["val"]))
    ax.plot(rounds, d["curves"]["2d"]["val"], "o-",
            label=f"2-D ({mesh_name(d)})")
    ax.plot(rounds, d["curves"]["1d"]["val"], "s--", label="1-D IST control")
    ax.set_xlabel("IST round")
    ax.set_ylabel("val accuracy")
    ax.set_title(f"2-D IST x graph sharding vs 1-D IST ({d['dataset']}, "
                 f"{d.get('hardware', '?')})", fontsize=9)
    ax.legend()
    ax.grid(alpha=0.3)
    return save(fig, results, "torch_r4_ist_sharded_2d.png")


def uw_family(results: str, points) -> list:
    """(h, K, record) of each ``(h, K)`` of ``points`` with a record."""
    runs = []
    for h, k in points:
        d = load(results, f"torch_amazon_uw_fullscale_h{h}_k{k}.json")
        if d is not None:
            runs.append((h, k, d))
    return runs


def plot_family(runs, title: str, time_title: str):
    """The family's val micro-F1 by round (left) and by train seconds
    (right)."""
    fig, (ax1, ax2) = plt().subplots(1, 2, figsize=(10, 3.8))
    for h, k, d in runs:
        evals = d.get("eval_rounds", range(len(d["val_accs"])))
        style = "-" if k > 1 else "--"
        ax1.plot(list(evals), d["val_accs"], style, marker="o",
                 label=f"h{h} K={k}")
        tt = d.get("train_time_at_eval")
        if tt:
            ax2.plot(tt, d["val_accs"], style, marker="o",
                     label=f"h{h} K={k}")
    ax1.set_xlabel("IST round")
    ax1.set_ylabel("val micro-F1")
    ax1.set_title(title, fontsize=9)
    ax2.set_xlabel("train seconds (excl. eval)")
    ax2.set_ylabel("val micro-F1")
    ax2.set_title(time_title, fontsize=9)
    for ax in (ax1, ax2):
        ax.legend(fontsize=8)
        ax.grid(alpha=0.3)
    return fig


def fig_uw_family(results: str):
    runs = uw_family(results, [(h, k) for h in (512, 1024, 2048)
                               for k in (1, 8)])
    if not runs:
        return None
    d = runs[0][2]
    fig = plot_family(runs, f"ultra-wide family ({d['dataset']}, "
                            f"{d.get('hardware', '?')})", "time-to-F1")
    return save(fig, results, "torch_r4_amazon_uw_family.png")


def fig_sharded_models(results: str):
    fig, ax = plt().subplots(figsize=(5.5, 3.5))
    drawn = []
    for model, name in (("GCN", "torch_sharded_gcn_reddit.json"),
                        ("GAT", "torch_sharded_gat_reddit.json")):
        d = load(results, name)
        if d is None:
            continue
        drawn.append(d)
        ax.plot(range(len(d["val_accs"])), d["val_accs"],
                label=f"sharded {model} (D={d.get('n_devices', '?')}), best "
                      f"{d['best_val_acc']:.3f}")
    if not drawn:
        plt().close(fig)
        return None
    ax.set_xlabel("epoch")
    ax.set_ylabel("val accuracy")
    ax.set_title(f"Graph-sharded GCN/GAT training ({drawn[0]['dataset']})",
                 fontsize=9)
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    return save(fig, results, "torch_r4_sharded_models.png")


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--results", default="results",
                   help="directory of the records and the figures")
    args = p.parse_args(argv)
    return [f for f in (fig_2d(args.results), fig_uw_family(args.results),
                        fig_sharded_models(args.results)) if f]


if __name__ == "__main__":
    main()
