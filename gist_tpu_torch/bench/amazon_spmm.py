"""K1 or K2 once per chunk over full synth-amazon2m
(``benchmarks/amazon_spmm_bench.py``).

    python -m gist_tpu_torch.bench.amazon_spmm [--log2-chunk 21]
        [--threshold 128] [--cu 1024] [--dataset synth-amazon2m]
        [--cache-dir data] [--device cuda|cpu] [--out PATH]

The JAX script's defaults: full synth-amazon2m (2,449,029 nodes, ~125M
edges, F=100), 64-row tiles, 2^21 unique-row slots a chunk, threshold
128, CU 1024 (its ``SPMM_CU``; K1 and K2 have CU 512 instances too).
``--threshold 0`` builds the v2 chunked layout and runs K1 once per
chunk (``ops/dedup_spmm.py:run_dedup_chunked``); a threshold above 0
builds the v3 split layout and runs K2 once per chunk.  The reference is
the segment path over edge chunks (``ops/spmm.py:spmm_segment_chunked``).

The JAX script compared a 50,000-row strided sample, because the
layout, the graph and both outputs did not fit in the TPU's 16 GB at
once; here the whole output is held against the segment path's
(``rel_err_vs_segment``, relative to max|segment|).  The layout is
cached under ``--cache-dir`` (``''``: no cache) in a file whose name
carries the tile rows, CU, chunk rows, threshold and a hash of the
graph.

One JSON line with the JAX keys (``n_chunks``, ``w_gib``,
``gathered_rows``, ``direct_jobs``, ``rel_err_vs_segment``,
``pallas_chunked_ms``, ``segment_chunked_ms``, ...) plus ``kernel``,
``bound_ms`` and ``bound_by`` (:func:`common.chunked_bound`, every byte
once), ``bound_share``, ``layout_build_s``, ``power_limit_w`` and
``kernel_launches``.  ``frac_of_per_edge_sol`` divides a per-edge model
(one F-wide fp32 row read per edge at the card's 3.35e12 B/s) by the
kernel's time: K1 and K2 read each unique (tile, sender) row once, so
they read it above 1; it is that model's ratio, not a share of a peak.
Default output ``results/torch_amazon_spmm_<layout>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from gist_tpu_torch.bench import common
from gist_tpu_torch.bench.timing import kernel_ms

DATASET = "synth-amazon2m"
TILE_ROWS = 64


def layout_name(threshold: int, cu: int) -> str:
    """``v2`` (chunked), ``v3t<threshold>`` (split), ``u<cu>`` appended
    for a CU other than 1024: the JAX script's names."""
    name = "v2" if threshold == 0 else f"v3t{threshold}"
    return name if cu == 1024 else f"{name}u{cu}"


def default_out(threshold: int, cu: int) -> str:
    return common.results_path(f"amazon_spmm_{layout_name(threshold, cu)}")


def cache_path(ds, cache_dir: str, *, threshold: int, cu: int,
               chunk_rows: int, tile_rows: int = TILE_ROWS):
    """The layout's cache file in ``cache_dir`` (None without one)."""
    if not cache_dir:
        return None
    digest = common.graph_digest(ds.senders, ds.receivers, ds.n_nodes)
    return os.path.join(
        cache_dir, f"torch_amazon_spmm_{ds.name}_tn{tile_rows}_cu{cu}"
        f"_c{chunk_rows}_t{threshold}_{digest}.npz")


def build_layout(ds, *, threshold: int, cu: int, chunk_rows: int,
                 tile_rows: int = TILE_ROWS):
    """The JAX script's layout: ``_build_dedup_chunked`` at threshold 0,
    else ``_build_dedup_split_chunked``."""
    from gist_tpu_torch.graph import (_build_dedup_chunked,
                                      _build_dedup_split_chunked)
    if threshold == 0:
        return _build_dedup_chunked(ds.senders, ds.receivers, ds.n_nodes,
                                    tile_rows=tile_rows, cu=cu,
                                    chunk_rows=chunk_rows)
    return _build_dedup_split_chunked(ds.senders, ds.receivers, ds.n_nodes,
                                      tile_rows=tile_rows, cu=cu,
                                      threshold=threshold,
                                      chunk_rows=chunk_rows)


def run(ds, dc, device, *, iters: int = 10, segment_iters: int = 3,
        plain: bool = False, seg_graph=None) -> dict:
    """The measurement on ``ds``'s features and its layout ``dc`` (a
    host or device ``ChunkedDedupTiles``): the chunked kernel pass (K1,
    or K2 on a split layout) against the segment path over the whole
    output, both timed (:func:`timing.kernel_ms`, ``iters`` and
    ``segment_iters`` windows).  ``plain`` also holds the pass against
    its plain walk (:func:`common.chunked_plain`; ``plain_rel_err``,
    relative to max|plain|).  ``seg_graph`` is the edge graph of ``ds``
    on ``device`` where the caller holds one."""
    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.ops.dedup_spmm import run_dedup_chunked
    from gist_tpu_torch.ops.spmm import spmm_segment_chunked
    dev = torch.device(device)
    before = common.launch_counts()
    e, n, f = len(ds.senders), ds.n_nodes, ds.in_feats
    threshold_layout = dc.is_dir is not None
    rec = {"dataset": ds.name, "n_nodes": n, "n_edges": e, "f": f,
           "kernel": "K2" if threshold_layout else "K1",
           "tile_rows": dc.tile_rows, "cu": dc.cu, "n_chunks": dc.n_chunks,
           "tiles_per_chunk": dc.tiles_per_chunk,
           "jobs_pad": int(dc.w_blocks.shape[1]),
           "w_gib": dc.w_blocks.numel() / 2 ** 30,
           "gathered_rows": int(dc.u_senders.numel()),
           "direct_jobs": 0 if dc.is_dir is None
           else int(dc.is_dir.sum()), **common.hardware(dev)}
    dc = dc.to(dev)
    x = torch.from_numpy(ds.features).to(dev)
    with torch.no_grad():
        got = run_dedup_chunked(dc, x, n)
        if plain:
            want = common.chunked_plain(dc, x, n)
            rec["plain_rel_err"] = common.rel_err(got, want)
            rec["plain_max_abs_err"] = float((got - want).abs().max())
            del want
        pal = kernel_ms(lambda: run_dedup_chunked(dc, x, n), windows=iters,
                        device=dev)
        out_rows = dc.n_chunks * dc.tiles_per_chunk * dc.tile_rows
        bound_ms, bound_by, nbytes, flops = common.chunked_bound(dc, x,
                                                                 out_rows)
        launches = common.launches_since(before)
        del dc
        g = seg_graph if seg_graph is not None else graph_from_edges(
            ds.senders, ds.receivers, n).to(dev)
        seg = spmm_segment_chunked(g, x)
        rec["rel_err_vs_segment"] = common.rel_err(got, seg)
        rec["max_abs_err_vs_segment"] = float((got - seg).abs().max())
        rec["finite"] = bool(torch.isfinite(got).all())
        del got, seg
        seg_ms = kernel_ms(lambda: spmm_segment_chunked(g, x),
                           windows=segment_iters, device=dev)
    sol_ms = e * f * 4 / common.HBM_BYTES_PER_S * 1e3
    rec.update({
        "pallas_chunked_ms": pal, "pallas_edges_per_sec": e / pal * 1e3,
        "segment_chunked_ms": seg_ms,
        "segment_edges_per_sec": e / seg_ms * 1e3,
        "speedup_vs_segment": seg_ms / pal,
        "frac_of_per_edge_sol": sol_ms / pal,
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
        "useful_flops": flops, "bound_share": bound_ms / pal,
        "kernel_launches": launches})
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--log2-chunk", type=int, default=21,
                   help="unique-row slots a chunk, log2 (JAX argv[1])")
    p.add_argument("--threshold", type=int, default=128,
                   help="0 = the v2 chunked layout (K1); else the v3 split "
                        "layout at this threshold (K2) (JAX argv[2])")
    p.add_argument("--cu", type=int, default=1024, choices=[512, 1024],
                   help="slots a job (JAX SPMM_CU)")
    p.add_argument("--dataset", default=DATASET)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--cache-dir", default="data",
                   help="layout cache directory ('' = none)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None,
                   help="default results/torch_amazon_spmm_<layout>.json")
    args = p.parse_args(argv)

    def go():
        from gist_tpu_torch.data import load_dataset
        from gist_tpu_torch.utils import resolve_device
        dev = resolve_device(args.device)
        chunk_rows = 2 ** args.log2_chunk
        t0 = time.time()
        ds = load_dataset(args.dataset)
        dataset_s = time.time() - t0
        print(json.dumps({"dataset": ds.name, "n_nodes": ds.n_nodes,
                          "n_edges": ds.n_edges, "seconds": dataset_s}),
              flush=True)
        t0 = time.time()
        path = cache_path(ds, args.cache_dir, threshold=args.threshold,
                          cu=args.cu, chunk_rows=chunk_rows)
        cached = bool(path) and os.path.exists(path)
        dc = common.cached_chunked(path, lambda: build_layout(
            ds, threshold=args.threshold, cu=args.cu,
            chunk_rows=chunk_rows))
        layout_s = time.time() - t0
        rec = run(ds, dc, dev, iters=args.iters)
        rec.update(layout=layout_name(args.threshold, args.cu),
                   threshold=args.threshold, chunk_rows=chunk_rows,
                   dataset_s=dataset_s, layout_build_s=layout_s,
                   layout_cached=cached)
        common.write_json(args.out or default_out(args.threshold, args.cu),
                          rec)
        return rec

    return common.script_main(go)


if __name__ == "__main__":
    raise SystemExit(main())
