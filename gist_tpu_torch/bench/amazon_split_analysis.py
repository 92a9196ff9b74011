"""The cost model of the direct/remote split over synth-amazon2m's
locality order (``benchmarks/amazon_split_analysis.py``).

    python -m gist_tpu_torch.bench.amazon_split_analysis [--tn 64]
        [--gather-rows-per-s R] [--stream-bytes-per-s B] [--permute-s S]
        [--dataset synth-amazon2m] [--log2-chunk 21] [--cache-dir data]
        [--device cuda|cpu] [--out PATH]

A model of the TPU kernel's design, kept as the JAX script has it: each
dst tile's senders fall in (tile, CU-row source block) pairs; a pair
with at least T edges becomes a *direct* job that streams its whole
source block, the others keep their unique (tile, sender) slots, which a
separate gather op fetches before the kernel.  For each threshold T the
counts (:func:`split_counts`: pairs, unique slots, direct jobs, remote
slots, remote jobs, W's GiB) are exact host numpy, array-equal to JAX's
``analyze``; the wall (:func:`split_wall`) is JAX's formula,
``remote_slots / gather_rows_per_s + (streamed rows * F_PAD * 4 + W
bytes) / stream_bytes_per_s + permute_s``, with its three rates as
inputs.  K1 on Hopper gathers its rows inside the kernel, so no separate
gather op exists on the card; ``kernel_tune``'s rows at TN 64, 128 and
256 (:mod:`.kernel_tune`) are the card's measured counterpart of what
the model predicts.

The locality order is the port's own v2 TN-64 layout
(:func:`.amazon_spmm.build_layout`, cached as :func:`.amazon_spmm.
cache_path` names it).  Unless given, the rates are measured on
``--device`` in the same run (:func:`measure_rates`): the gather rate
as rows/s of ``torch.index_select`` of ``F_PAD``-wide fp32 rows from a
table the size of the dataset's x, indexed by the layout's own slot ids
(up to ``GATHER_ROWS_MAX`` of them); the stream rate as bytes/s of a
contiguous read of that table (a sum over it); the permute time as the
time of the permutation of x's rows into the layout's order and of the
output's back.  The record names each rate's source.

One JSON object: ``rows`` (per T the JAX keys ``T``, ``direct_jobs``,
``remote_slots``, ``remote_jobs``, ``w_gib``, ``t_gather_ms``,
``t_pipe_ms``, ``t_total_ms``, ``edges_per_s_M``, unrounded, plus
``total_jobs``), ``pairs``, ``unique_slots``, ``rates`` (each with its
``*_source``), ``note``, the card's name and power limit; default output
``results/torch_amazon_split_analysis_tn{TN}.json``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from gist_tpu_torch.bench import common

F_PAD = 128          # feature tile (F=100 padded)
CU = 1024
THRESHOLDS = (32, 64, 96, 128, 192, 256, 384, 512)
GATHER_ROWS_MAX = 1 << 24
# each rate of the model and the key of its source in a record
SOURCE_KEYS = {"gather_rows_per_s": "gather_source",
               "stream_bytes_per_s": "stream_source",
               "permute_s": "permute_source",
               "budget_gib": "budget_source"}
NOTE = ("a model of the TPU kernel's design (a gather op before the "
        "kernel, direct jobs streamed by its pipeline); K1 on Hopper "
        "gathers rows inside the kernel, and kernel_tune's rows at TN 64, "
        "128 and 256 are the card's measured counterpart")


def split_counts(tn: int, senders, receivers, pos, thresholds):
    """(pairs, unique slots, one row of counts per threshold): JAX's
    ``analyze`` counts, on the order ``pos`` (node -> row)."""
    r_p = pos[receivers]
    s_p = pos[senders]
    tile_of = r_p // tn
    blk_of = s_p // CU
    n_blocks = int(blk_of.max()) + 1
    pair_key = tile_of.astype(np.int64) * n_blocks + blk_of
    pk, pcnt = np.unique(pair_key, return_counts=True)
    width = int(s_p.max()) + 1
    uk = np.unique(tile_of.astype(np.int64) * width + s_p)
    u_tile = uk // width
    u_pair_key = u_tile * n_blocks + (uk % width) // CU
    u_pair = np.searchsorted(pk, u_pair_key)
    u_per_pair = np.bincount(u_pair, minlength=len(pk))
    rows = []
    for t in thresholds:
        dense = pcnt >= t
        direct_jobs = int(dense.sum())
        remote_slots = int(u_per_pair[~dense].sum())
        # remote slots are CU-padded per tile
        per_tile = np.bincount(u_tile[~dense[u_pair]])
        remote_jobs = int(np.ceil(per_tile / CU).sum())
        total = direct_jobs + remote_jobs
        rows.append({"T": t, "direct_jobs": direct_jobs,
                     "remote_slots": remote_slots, "remote_jobs": remote_jobs,
                     "total_jobs": total, "w_gib": total * tn * CU / 2 ** 30})
    return len(pk), len(uk), rows


def split_wall(row: dict, tn: int, n_edges: int, *, gather_rows_per_s: float,
               stream_bytes_per_s: float, permute_s: float) -> dict:
    """JAX's modelled wall of one threshold's counts at the given rates."""
    t_gather = row["remote_slots"] / gather_rows_per_s
    stream_rows = (row["direct_jobs"] + row["remote_jobs"]) * CU
    t_pipe = (stream_rows * F_PAD * 4 + row["total_jobs"] * tn * CU) \
        / stream_bytes_per_s
    t_total = t_gather + t_pipe + permute_s
    return {"t_gather_ms": t_gather * 1e3, "t_pipe_ms": t_pipe * 1e3,
            "t_total_ms": t_total * 1e3,
            "edges_per_s_M": n_edges / t_total / 1e6}


def permutation_layout(ds, *, cache_dir="data", log2_chunk: int = 21):
    """The port's v2 TN-64 chunked layout of ``ds`` (cached under
    ``cache_dir``, '' for none): its ``pos`` is the locality order."""
    from gist_tpu_torch.bench import amazon_spmm
    chunk_rows = 2 ** log2_chunk
    path = amazon_spmm.cache_path(ds, cache_dir, threshold=0, cu=CU,
                                  chunk_rows=chunk_rows)
    return common.cached_chunked(path, lambda: amazon_spmm.build_layout(
        ds, threshold=0, cu=CU, chunk_rows=chunk_rows))


def host_memory_bytes() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def measure_rates(n_nodes: int, dc, device, iters: int = 5) -> dict:
    """The model's rates measured on ``device`` (:func:`timing.kernel_ms`;
    on the CPU its wall clock), each with its source: the gather rate
    over the layout ``dc``'s own slot ids, the stream rate of a sum over
    an (n_nodes, F_PAD) fp32 table, the permute time of that table's
    rows into ``dc``'s order and back, and the memory left beside x and
    the output (``budget_gib``: the card's, or on the CPU the host's)."""
    from gist_tpu_torch.bench.timing import kernel_ms
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((n_nodes, F_PAD), generator=g, device=dev)
    idx = dc.u_senders.reshape(-1)[:GATHER_ROWS_MAX].to(dev, torch.long)
    perm, pos = dc.perm.to(dev, torch.long), dc.pos.to(dev, torch.long)
    where = (f"{common.hardware(dev)['hardware']}, timing.kernel_ms"
             if dev.type == "cuda" else "the CPU's wall clock, a CPU run")
    with torch.no_grad():
        gather_ms = kernel_ms(lambda: table.index_select(0, idx),
                              windows=iters, device=dev)
        stream_ms = kernel_ms(lambda: table.sum(), windows=iters, device=dev)
        permute_ms = kernel_ms(lambda: (table.index_select(0, perm),
                                        table.index_select(0, pos)),
                               windows=iters, device=dev)
    n_idx, table_bytes = idx.numel(), table.numel() * 4
    total = (torch.cuda.get_device_properties(dev).total_memory
             if dev.type == "cuda" else host_memory_bytes())
    return {
        "gather_rows_per_s": n_idx / gather_ms * 1e3,
        "gather_source": f"torch.index_select of {n_idx} of the layout's "
                         f"slot ids, {F_PAD}-wide fp32 rows of an "
                         f"({n_nodes}, {F_PAD}) table, measured ({where})",
        "stream_bytes_per_s": table_bytes / stream_ms * 1e3,
        "stream_source": f"a sum over the ({n_nodes}, {F_PAD}) fp32 table, "
                         f"measured ({where})",
        "permute_s": permute_ms / 1e3,
        "permute_source": f"the table's rows into the layout's order and "
                          f"back, two index_select, measured ({where})",
        "budget_gib": (total - 2 * table_bytes) / 2 ** 30,
        "budget_source": f"{'the card' if dev.type == 'cuda' else 'host'}"
                         f" memory {total / 2 ** 30:.2f} GiB less x and "
                         f"the output ({n_nodes} x {F_PAD} fp32 each)"}


def rates_for(given: dict, n_nodes: int, dc, device) -> dict:
    """The rates a script uses: each of ``given`` (rate name -> value or
    None) that has a value, its source ``given``; the others measured
    (:func:`measure_rates`), which runs only if one is missing."""
    rates = {}
    if any(v is None for v in given.values()):
        rates = measure_rates(n_nodes, dc, device)
    for k, v in given.items():
        if v is not None:
            rates.update({k: v, SOURCE_KEYS[k]: "given"})
    return rates


def given_rates(args) -> dict:
    """The rate flags of a script's arguments (None where not given)."""
    return {k: getattr(args, k) for k in SOURCE_KEYS if hasattr(args, k)}


def analysis(ds, dc, tn: int, rates: dict, thresholds=THRESHOLDS) -> dict:
    """The record of ``ds`` on the order of ``dc`` at tile rows ``tn``."""
    t0 = time.time()
    pos = dc.pos.numpy().astype(np.int64)
    pairs, slots, rows = split_counts(tn, ds.senders, ds.receivers, pos,
                                      thresholds)
    e = len(ds.senders)
    for row in rows:
        row.update(split_wall(row, tn, e, **{
            k: rates[k] for k in ("gather_rows_per_s", "stream_bytes_per_s",
                                  "permute_s")}))
    return {"dataset": ds.name, "n_nodes": ds.n_nodes, "n_edges": e,
            "tn": tn, "cu": CU, "f_pad": F_PAD, "pairs": pairs,
            "unique_slots": slots, "rows": rows, "rates": rates,
            "order": f"the port's v2 TN-{dc.tile_rows} layout's locality "
                     f"order", "analysis_s": time.time() - t0, "note": NOTE}


def add_rate_flags(p, budget: bool = False) -> None:
    p.add_argument("--gather-rows-per-s", type=float, default=None,
                   help="default: measured in this run")
    p.add_argument("--stream-bytes-per-s", type=float, default=None,
                   help="default: measured in this run")
    p.add_argument("--permute-s", type=float, default=None,
                   help="default: measured in this run")
    if budget:
        p.add_argument("--budget-gib", type=float, default=None,
                       help="default: the device's memory less x and the "
                            "output")
    p.add_argument("--dataset", default="synth-amazon2m")
    p.add_argument("--log2-chunk", type=int, default=21,
                   help="the order's layout: unique-row slots a chunk, log2")
    p.add_argument("--cache-dir", default="data",
                   help="layout cache directory ('' = none)")
    p.add_argument("--device", default="cuda")


def load(args):
    """(dataset, its order's layout, the device) of a script's flags."""
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.utils import resolve_device
    dev = resolve_device(args.device)
    ds = load_dataset(args.dataset)
    dc = permutation_layout(ds, cache_dir=args.cache_dir,
                            log2_chunk=args.log2_chunk)
    return ds, dc, dev


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tn", type=int, default=64, help="JAX argv[1]")
    add_rate_flags(p)
    p.add_argument("--out", default=None, help="default results/torch_"
                   "amazon_split_analysis_tn{TN}.json")
    args = p.parse_args(argv)

    def go():
        ds, dc, dev = load(args)
        rec = analysis(ds, dc, args.tn, rates_for(given_rates(args),
                                                   ds.n_nodes, dc, dev))
        rec.update(common.hardware(dev))
        common.write_json(args.out or common.results_path(
            f"amazon_split_analysis_tn{args.tn}"), rec)
        return rec

    return common.script_main(go)


if __name__ == "__main__":
    raise SystemExit(main())
