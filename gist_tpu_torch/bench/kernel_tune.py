"""K1 across destination tile sizes, and a row gather's rate
(``benchmarks/kernel_tune.py``).

    python -m gist_tpu_torch.bench.kernel_tune [--dataset
        synth-reddit-small] [--device cuda|cpu]
        [--out results/torch_kernel_tune.json]

For TN in (64, 128, 256) and fp32 and bf16: the flat forward layout of
synth-reddit-small at that tile size, and K1's time on it.  Bigger
tiles share senders across more rows (``d_slot``, unique slots over
edges, falls) at the price of a larger W (``w_mib``).  Each row has the
JAX script's keys (``tile_rows``, ``dtype``, ``d_slot``, ``w_mib``,
``ms``, ``edges_per_s_M``), ``bound_ms`` and ``bound_by``, K1's least
time on those inputs, and K1's output against its plain walk
(``max_abs_err``, ``rel_err`` relative to the plain result's max, the
bar ``tol``) and against a second launch (``bitwise_repeat``).  Then
``index_select`` of 2^20 seeded rows of the features padded to 602, 608
and 640 columns (``cols``, ``ms_per_1M_rows``, ``GB_s``,
``rows_per_s_M``): does the row width's alignment change the gather
rate?  One JSON line per row; the whole record goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gist_tpu_torch.bench import common
from gist_tpu_torch.bench.timing import kernel_ms
from gist_tpu_torch.ops.dedup_spmm import (TILE_SIZES, dedup_spmm,
                                           dedup_spmm_reference, spmm_dedup)

DEFAULT_OUT = common.results_path("kernel_tune")
GATHER_ROWS = 1 << 20
GATHER_COLS = (602, 608, 640)
# K1 against its plain walk, relative to the plain result's max
TOL = {"fp32": 1e-5, "bf16": 1e-2}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="K1 by tile size")
    p.add_argument("--dataset", default="synth-reddit-small")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)

    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.utils import resolve_device

    dev = resolve_device(args.device)
    ds = load_dataset(args.dataset)
    e, f = len(ds.senders), ds.features.shape[1]
    x32 = torch.from_numpy(ds.features).to(dev)
    rows = []
    for tn in TILE_SIZES:
        g = graph_from_edges(ds.senders, ds.receivers, ds.n_nodes,
                             tiles=True, tile_rows=tn)
        if g.dedup is None:
            raise RuntimeError(f"the dedup layout did not build at TN={tn}")
        g = g.replace(dedup_t=None).to(dev)
        d = g.dedup
        d_slot = int(d.job_offsets[-1]) * d.cu / e
        w_mib = d.w_blocks.numel() / 2 ** 20
        for dtype, x in (("fp32", x32), ("bf16", x32.to(torch.bfloat16))):
            with torch.no_grad():
                got, again = (dedup_spmm(d.job_offsets, d.w_blocks,
                                         d.u_senders, x) for _ in range(2))
                want = dedup_spmm_reference(d.job_offsets, d.w_blocks,
                                            d.u_senders, x)
                ms = kernel_ms(lambda: spmm_dedup(g, x), device=dev)
            bound_ms, bound_by = common.k1_bound(d, x, d.num_tiles * tn)[:2]
            rows.append({"tile_rows": tn, "dtype": dtype, "d_slot": d_slot,
                         "w_mib": w_mib, "ms": ms,
                         "edges_per_s_M": e / ms / 1e3,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "max_abs_err": float(
                             (got.float() - want.float()).abs().max()),
                         "rel_err": common.rel_err(got, want),
                         "tol": TOL[dtype],
                         "bitwise_repeat": bool(torch.equal(got, again))})
            print(json.dumps(rows[-1]), flush=True)

    gather = []
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, ds.n_nodes, GATHER_ROWS)).to(dev)
    for cols in GATHER_COLS:
        xv = torch.nn.functional.pad(x32, (0, max(cols - f, 0)))
        ms = kernel_ms(lambda: xv.index_select(0, idx), device=dev)
        gather.append({"cols": cols,
                       "ms_per_1M_rows": ms * (1 << 20) / len(idx),
                       "GB_s": len(idx) * cols * 4 / ms / 1e6,
                       "rows_per_s_M": len(idx) / ms / 1e3})
        print(json.dumps(gather[-1]), flush=True)

    out = {"dataset": args.dataset, "n_edges": e, "f": f,
           **common.hardware(dev), "rows": rows, "gather_microbench": gather}
    common.write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
