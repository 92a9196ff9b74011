"""The round-5 figures (``benchmarks/r5_figures.py``) from the port's
records.

    python -m gist_tpu_torch.bench.r5_figures [--results results]

Renders what records exist and skips the rest, and writes
``results/torch_r5_*.png``:

* ``torch_r5_amazon_uw_family_chip.png``: the one-card ultra-wide
  family, h2048 at K = 1, 2, 4 and 8 beside h512 at K = 1 and 8, val
  micro-F1 by round and by train seconds, from
  ``torch_amazon_uw_fullscale_h{H}_k{K}.json``
  (:mod:`.amazon_uw_fullscale`: the K subnets one after another on one
  card);
* ``torch_r5_ist_sharded_2d.png``: the 2-D run against its 1-D control,
  val accuracy and each round's wall, from ``torch_ist_sharded_2d.json``
  (``curves.{2d,1d}.{val,wall}``).

Titles name the card each record gives.  Needs matplotlib (not on the
card's machine).
"""

from __future__ import annotations

import argparse

from gist_tpu_torch.bench.r4_figures import (load, mesh_name, plot_family,
                                             plt, save, uw_family)

FAMILY = ((512, 1), (512, 8), (2048, 1), (2048, 2), (2048, 4), (2048, 8))


def fig_uw_family_chip(results: str):
    runs = uw_family(results, FAMILY)
    if not runs:
        return None
    d = runs[0][2]
    lr = d.get("config", {}).get("lr")
    fig = plot_family(
        runs, f"{d['dataset']} ultra-wide family on one card "
              f"({d.get('hardware', '?')}, lr {lr})",
        "time-to-F1 (sequential subnets, one card)")
    return save(fig, results, "torch_r5_amazon_uw_family_chip.png")


def fig_2d(results: str):
    d = load(results, "torch_ist_sharded_2d.json")
    if d is None:
        return None
    fig, (ax1, ax2) = plt().subplots(1, 2, figsize=(10, 3.5))
    rounds = range(len(d["curves"]["2d"]["val"]))
    ax1.plot(rounds, d["curves"]["2d"]["val"], "o-",
             label=f"2-D ({mesh_name(d)})")
    ax1.plot(rounds, d["curves"]["1d"]["val"], "s--",
             label="1-D IST control")
    ax1.set_xlabel("IST round")
    ax1.set_ylabel("val accuracy")
    ax1.set_title(f"2-D vs 1-D IST ({d['dataset']}, "
                  f"{d.get('hardware', '?')})", fontsize=9)
    ax2.plot(rounds, d["curves"]["2d"]["wall"], "o-", label="2-D wall")
    ax2.plot(rounds, d["curves"]["1d"]["wall"], "s--", label="1-D wall")
    ax2.set_xlabel("IST round")
    ax2.set_ylabel("round wall (s)")
    ax2.set_title("round walls", fontsize=9)
    for ax in (ax1, ax2):
        ax.legend()
        ax.grid(alpha=0.3)
    return save(fig, results, "torch_r5_ist_sharded_2d.png")


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--results", default="results",
                   help="directory of the records and the figures")
    args = p.parse_args(argv)
    return [f for f in (fig_uw_family_chip(args.results),
                        fig_2d(args.results)) if f]


if __name__ == "__main__":
    main()
