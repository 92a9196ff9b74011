"""The multi-head GAT attention once per chunk at real Reddit's edge
count (``benchmarks/gat_chunked_bench.py``).

    python -m gist_tpu_torch.bench.gat_chunked [--dataset synth-reddit-full]
        [--hidden 128] [--heads 2] [--iters 3] [--dtype float32|bfloat16]
        [--chunk-rows 2097152] [--cache-dir data] [--device cuda|cpu]
        [--out results/torch_gat_chunked.json]

The JAX script's defaults (its ``GATC_*`` variables become the flags):
synth-reddit-full (232,965 nodes, ~115M symmetrised edges), D=128, 2
heads, 3 timed calls, fp32, 2^21 unique-row slots a chunk.  Measured:

* the forward-only chunked layout's build (``with_tiles(mode=
  "dedup-chunked", transpose=False)``, 128-row tiles; cached under
  ``--cache-dir`` in a file named by the chunk rows and a hash of the
  graph, ``''`` for none);
* the all-heads attention through K4 once per chunk
  (``ops/gat_dedup.py:gat_attention_dedup_chunked``), z (N, H, D) and
  scores from ``default_rng(0)``: ``attention_fwd_ms`` is the least of
  ``--iters`` calls between two CUDA events (the JAX walls), ``_kernel_ms``
  device time per call (:func:`timing.kernel_ms`), beside its byte bound;
* the JAX script's independent check: with every score zero the
  attention is the mean over each row's in-edges, so it must equal K1
  once per chunk (``run_dedup_chunked``) times 1/in_deg
  (``zero_score_rel_err_vs_spmm``, relative to the max; held at 1e-5);
* a full 2-layer ``gat.apply`` eval (params from a CPU generator seeded
  0), its seconds and its untrained val micro-F1.

One JSON line with the JAX keys plus ``attention_fwd_kernel_ms``,
``bound_ms``, ``bound_by``, ``power_limit_w`` and ``kernel_launches``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from gist_tpu_torch.bench import common
from gist_tpu_torch.bench.timing import kernel_ms

DEFAULT_OUT = common.results_path("gat_chunked")
ZERO_SCORE_TOL = 1e-5


def cache_path(ds, cache_dir: str, chunk_rows: int, tile_rows: int = 128):
    if not cache_dir:
        return None
    digest = common.graph_digest(ds.senders, ds.receivers, ds.n_nodes)
    return os.path.join(cache_dir, f"torch_gat_chunked_{ds.name}_tn"
                        f"{tile_rows}_c{chunk_rows}_{digest}.npz")


def build_graph(ds, chunk_rows: int, cache_dir: str = ""):
    """(the edge graph of ``ds`` carrying only its forward chunked layout,
    its build seconds).  The layout comes from the cache when built
    before."""
    from gist_tpu_torch.graph import graph_from_edges
    t0 = time.time()
    g = graph_from_edges(ds.senders, ds.receivers, ds.n_nodes)
    dc = common.cached_chunked(
        cache_path(ds, cache_dir, chunk_rows),
        lambda: g.with_tiles(mode="dedup-chunked", chunk_rows=chunk_rows,
                             transpose=False).dedup_c)
    return g.replace(dedup_c=dc), time.time() - t0


def fwd_bound(t, z):
    """K4 per chunk's least time: the layout's real jobs, z and the
    scores read once, out, m and l written once, against the nonzero
    counts' work (a score, an exp and the D-wide FMA a head)."""
    nbytes, flops = common.chunked_bound(t, z.reshape(z.shape[0], -1),
                                         0)[2:]
    heads, d = z.shape[1], z.shape[2]
    rows = t.n_chunks * t.tiles_per_chunk * t.tile_rows
    nnz = flops // (2 * heads * d)
    nbytes += z.shape[0] * heads * 8 + rows * heads * (d * z.element_size()
                                                       + 8)
    return common.bound(nbytes, nnz * heads * (2 * d + 6), z.dtype)


def run(ds, graph, device, *, hidden: int = 128, heads: int = 2,
        iters: int = 3, dtype: str = "float32") -> dict:
    """The measurements on ``ds`` and ``graph`` (its edge graph with the
    forward chunked layout ``dedup_c``, on ``device``)."""
    from gist_tpu_torch.models import gat
    from gist_tpu_torch.models.common import micro_f1
    from gist_tpu_torch.ops.dedup_spmm import run_dedup_chunked
    from gist_tpu_torch.ops.gat_dedup import gat_attention_dedup_chunked
    from gist_tpu_torch.train.common import seeded_init
    dev = torch.device(device)
    t = graph.dedup_c
    n, e = ds.n_nodes, len(ds.senders)
    before = common.launch_counts()
    rng = np.random.default_rng(0)
    dt = getattr(torch, dtype)
    z = torch.from_numpy(rng.standard_normal(
        (n, heads, hidden)).astype(np.float32)).to(dev).to(dt)
    a = torch.from_numpy(rng.standard_normal((n, heads)).astype(
        np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal((n, heads)).astype(
        np.float32)).to(dev)
    cuda = dev.type == "cuda"

    def fwd():
        return gat_attention_dedup_chunked(graph, z, a, b, 0.01)

    with torch.no_grad():
        fwd()
        walls = []
        for _ in range(iters):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fwd()
            if cuda:
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            del out
        fwd_kernel_ms = kernel_ms(fwd, windows=iters, device=dev)
        bound_ms, bound_by = fwd_bound(t, z)

        z0 = z[:, 0].float().contiguous()
        zeros = torch.zeros((n, 1), device=dev)
        att = gat_attention_dedup_chunked(graph, z0[:, None], zeros, zeros,
                                          0.01)[:, 0]
        agg = run_dedup_chunked(t, z0, n)
        deg = graph.in_degrees.to(dev)[:, None]
        want = torch.where(deg > 0, agg / deg.clamp(min=1.0),
                           torch.zeros_like(agg))
        err = common.rel_err(att, want)
        del z, z0, att, agg, want

        cfg = gat.GATConfig(ds.in_feats, hidden, ds.n_classes, n_layers=2,
                            n_heads=heads)
        params = seeded_init(gat, cfg, 0, dev)
        x = torch.from_numpy(ds.features).to(dev)
        gat.apply(params, graph, x, cfg, backend="dedup")
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = gat.apply(params, graph, x, cfg, backend="dedup")
        if cuda:
            torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        f1 = micro_f1(logits.float().cpu().numpy(), ds.labels, ds.val_mask)
    fwd_s = min(walls)
    return {
        "dataset": ds.name, "n_nodes": n, "n_edges": e, "hidden": hidden,
        "heads": heads, "dtype": dtype, **common.hardware(dev),
        "layout": {"n_chunks": t.n_chunks,
                   "tiles_per_chunk": t.tiles_per_chunk,
                   "jobs_pad": int(t.w_blocks.shape[1]),
                   "w_gib": t.w_blocks.numel() / 2 ** 30,
                   "max_jobs": t.max_jobs},
        "attention_fwd_ms": fwd_s * 1e3,
        "attention_fwd_walls_s": walls,
        "attention_fwd_kernel_ms": fwd_kernel_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "edges_per_sec": e / fwd_s,
        "zero_score_rel_err_vs_spmm": err,
        "zero_score_tol": ZERO_SCORE_TOL,
        "full_eval_2layer_s": eval_s, "untrained_val_f1": f1,
        "logits_finite": bool(torch.isfinite(logits).all()),
        "kernel_launches": common.launches_since(before)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", default="synth-reddit-full")
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--chunk-rows", type=int, default=2 ** 21)
    p.add_argument("--cache-dir", default="data",
                   help="layout cache directory ('' = none)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)

    def go():
        from gist_tpu_torch.data import load_dataset
        from gist_tpu_torch.utils import resolve_device
        dev = resolve_device(args.device)
        t0 = time.time()
        ds = load_dataset(args.dataset)
        dataset_s = time.time() - t0
        print(json.dumps({"dataset": ds.name, "n_nodes": ds.n_nodes,
                          "n_edges": ds.n_edges, "seconds": dataset_s}),
              flush=True)
        graph, layout_s = build_graph(ds, args.chunk_rows, args.cache_dir)
        rec = run(ds, graph.to(dev), dev, hidden=args.hidden,
                  heads=args.heads, iters=args.iters, dtype=args.dtype)
        rec.update(chunk_rows=args.chunk_rows, dataset_s=dataset_s,
                   layout_build_s=layout_s)
        common.write_json(args.out, rec)
        return rec

    return common.script_main(go)


if __name__ == "__main__":
    raise SystemExit(main())
