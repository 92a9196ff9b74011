"""The tile-size cost model of the chunked SpMM over synth-amazon2m
(``benchmarks/amazon_tn_analysis.py``).

    python -m gist_tpu_torch.bench.amazon_tn_analysis
        [--gather-rows-per-s R] [--stream-bytes-per-s B] [--permute-s S]
        [--budget-gib G] [--dataset synth-amazon2m] [--log2-chunk 21]
        [--cache-dir data] [--device cuda|cpu] [--out PATH]

The JAX script's model, of the TPU kernel's design: unique (tile,
sender) slots shrink as tiles grow, cutting the separate gather op's
rows, at the price of a bigger W.  For tile rows 64, 128, 256 and 512
(128 and 256 also with the split at threshold 512), all on the TN-64
locality order, :func:`tn_counts` gives the exact slot count, the
remote and direct jobs after CU padding and W's GiB (array-equal to
JAX's ``model``), and :func:`tn_wall` JAX's wall, ``remote jobs * CU /
gather_rows_per_s + (jobs * CU * F_PAD * 4 + W bytes) /
stream_bytes_per_s + permute_s``, with ``fits`` against
``budget_gib``.  The rates and the budget are inputs, measured on
``--device`` in the same run unless given
(:func:`.amazon_split_analysis.measure_rates`); the budget is the
device's memory less x and the output, as JAX's constant budget was
its own chip's memory less the same.  K1 on Hopper gathers inside the
kernel, so the model is of the TPU's design; ``kernel_tune``'s rows at
TN 64, 128 and 256 are the card's measured counterpart.

One JSON object: ``rows`` (JAX's keys ``tn``, ``T``, ``slots_M``,
``rem_jobs``, ``direct_jobs``, ``w_gib``, ``fits``, ``t_gather_ms``,
``t_pipe_ms``, ``t_total_ms``, ``edges_per_s_M``, ``analysis_s``,
unrounded, plus ``slots``), ``rates`` with their sources, ``note``, the
card's name and power limit; default output
``results/torch_amazon_tn_analysis.json``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from gist_tpu_torch.bench import common
from gist_tpu_torch.bench.amazon_split_analysis import (CU, F_PAD, NOTE,
                                                        add_rate_flags,
                                                        given_rates, load,
                                                        rates_for)

DEFAULT_OUT = common.results_path("amazon_tn_analysis")
# the JAX script's (tile rows, thresholds) in its order; None: no split
PLAN = ((64, (None,)), (128, (None, 512)), (256, (None, 512)),
        (512, (None,)))


def tn_counts(tn: int, senders_p, receivers_p, thresholds=(None,)):
    """One row of counts per threshold: JAX's ``model`` counts on the
    permuted senders and receivers."""
    tile_of = receivers_p // tn
    num_tiles = int(tile_of.max()) + 1
    width = int(senders_p.max()) + 1
    t0 = time.time()
    uk = np.unique(tile_of.astype(np.int64) * width + senders_p)
    u_tile = uk // width
    u_cnt = np.bincount(u_tile, minlength=num_tiles)
    slots = len(uk)
    jobs = int(np.ceil(u_cnt / CU).sum())
    rows = []
    for t in thresholds:
        if t is None:
            rem_jobs, direct_jobs = jobs, 0
        else:
            blk = (uk % width) // CU
            n_blocks = int(blk.max()) + 1
            pair = u_tile * n_blocks + blk
            # the threshold counts edges per pair
            e_pair = tile_of.astype(np.int64) * n_blocks + senders_p // CU
            pk, pcnt = np.unique(e_pair, return_counts=True)
            dense = pcnt >= t
            slot_dense = dense[np.searchsorted(pk, pair)]
            rem_per_tile = np.bincount(u_tile[~slot_dense],
                                       minlength=num_tiles)
            rem_jobs = int(np.ceil(rem_per_tile / CU).sum())
            direct_jobs = int(dense.sum())
        total = rem_jobs + direct_jobs
        rows.append({"tn": tn, "T": t, "slots": slots,
                     "slots_M": slots / 1e6, "rem_jobs": rem_jobs,
                     "direct_jobs": direct_jobs,
                     "w_gib": total * tn * CU / 2 ** 30,
                     "analysis_s": time.time() - t0})
    return rows


def tn_wall(row: dict, n_edges: int, *, gather_rows_per_s: float,
            stream_bytes_per_s: float, permute_s: float,
            budget_gib: float) -> dict:
    """JAX's modelled wall of one row's counts at the given rates, and
    whether W fits ``budget_gib``."""
    total = row["rem_jobs"] + row["direct_jobs"]
    t_gather = row["rem_jobs"] * CU / gather_rows_per_s
    t_pipe = (total * CU * F_PAD * 4 + total * row["tn"] * CU) \
        / stream_bytes_per_s
    t_total = t_gather + t_pipe + permute_s
    return {"fits": row["w_gib"] <= budget_gib,
            "t_gather_ms": t_gather * 1e3, "t_pipe_ms": t_pipe * 1e3,
            "t_total_ms": t_total * 1e3,
            "edges_per_s_M": n_edges / t_total / 1e6}


def analysis(ds, dc, rates: dict, plan=PLAN) -> dict:
    """The record of ``ds`` on the order of ``dc`` for every (tile rows,
    thresholds) of ``plan``."""
    pos = dc.pos.numpy().astype(np.int64)
    s_p, r_p = pos[ds.senders], pos[ds.receivers]
    e = len(ds.senders)
    rows = []
    for tn, thresholds in plan:
        for row in tn_counts(tn, s_p, r_p, thresholds):
            row.update(tn_wall(row, e, **{k: rates[k] for k in (
                "gather_rows_per_s", "stream_bytes_per_s", "permute_s",
                "budget_gib")}))
            rows.append(row)
    return {"dataset": ds.name, "n_nodes": ds.n_nodes, "n_edges": e,
            "cu": CU, "f_pad": F_PAD, "rows": rows, "rates": rates,
            "order": f"the port's v2 TN-{dc.tile_rows} layout's locality "
                     f"order", "note": NOTE}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_rate_flags(p, budget=True)
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)

    def go():
        ds, dc, dev = load(args)
        rec = analysis(ds, dc, rates_for(given_rates(args), ds.n_nodes, dc,
                                         dev))
        rec.update(common.hardware(dev))
        common.write_json(args.out, rec)
        return rec

    return common.script_main(go)


if __name__ == "__main__":
    raise SystemExit(main())
