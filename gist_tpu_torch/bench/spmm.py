"""SpMM aggregation by backend (``benchmarks/spmm_bench.py``).

    python -m gist_tpu_torch.bench.spmm [--dataset synth-reddit-small]
        [--backends pallas,segment] [--dtype float32|bfloat16] [--grad]
        [--iters 10] [--device cuda|cpu] [--out results/torch_spmm.json]

``pallas`` is the kernel backend (``ops/dedup_spmm.spmm_dedup``: K1 on
the flat layout), ``segment`` gather and ``index_add_``.  ``--grad``
also times ``grad(sum(agg(x)**2))`` (K1 forward, then K1 on the
transpose layout).  One JSON line per measurement, with the JAX
script's keys (``op``, ``backend``, ``dtype``, ``dataset``, ``E``,
``F``, ``ms``, ``edges_per_sec``), plus ``hardware`` and
``power_limit_w``; all of them also go to ``--out``.  ``ms`` is device
time per call (:func:`timing.kernel_ms`, ``--iters`` windows) on the
card, the median wall clock of ``--iters`` calls on the CPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from gist_tpu_torch.bench import common
from gist_tpu_torch.bench.timing import kernel_ms

DEFAULT_OUT = common.results_path("spmm")


def k1_fwd_ms(ds, device, dtypes=("float32", "bfloat16"),
              iters: int = 10) -> dict:
    """K1's forward (the ``pallas`` backend) on ``ds``'s flat layout at
    each of ``dtypes``: ``{dtype: ms}``, device time per call
    (:func:`timing.kernel_ms`, ``iters`` windows; on the CPU the wall
    clock of the plain walk the wrapper runs there)."""
    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.ops.dedup_spmm import spmm_dedup
    dev = torch.device(device)
    g = graph_from_edges(ds.senders, ds.receivers, ds.n_nodes,
                         tiles=True).to(dev)
    if g.dedup is None:
        raise RuntimeError(f"{ds.name}'s flat dedup layout did not build")
    out = {}
    with torch.no_grad():
        for dtype in dtypes:
            x = torch.from_numpy(ds.features).to(dev, getattr(torch, dtype))
            out[dtype] = kernel_ms(lambda: spmm_dedup(g, x), windows=iters,
                                   device=dev)
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description="SpMM by backend")
    p.add_argument("--dataset", default="synth-reddit-small")
    p.add_argument("--backends", default="pallas,segment")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--grad", action="store_true")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)

    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.ops.dedup_spmm import spmm_dedup
    from gist_tpu_torch.ops.spmm import spmm_segment
    from gist_tpu_torch.utils import resolve_device

    dev = resolve_device(args.device)
    backends = args.backends.split(",")
    fns = {"pallas": spmm_dedup, "segment": spmm_segment}
    if set(backends) - set(fns):
        raise ValueError(f"backends are {sorted(fns)}, not {backends}")
    ds = load_dataset(args.dataset)
    g = graph_from_edges(ds.senders, ds.receivers, ds.n_nodes,
                         tiles="pallas" in backends).to(dev)
    x = torch.from_numpy(ds.features).to(getattr(torch, args.dtype)).to(dev)
    e, f = g.n_edges, x.shape[1]
    stamp = common.hardware(dev)
    rows = []

    def emit(op, name, fn):
        ms = kernel_ms(fn, windows=args.iters, device=dev)
        rows.append({"op": op, "backend": name, "dtype": args.dtype,
                     "dataset": args.dataset, "E": e, "F": f, "ms": ms,
                     "edges_per_sec": e / ms * 1e3, **stamp})
        print(json.dumps(rows[-1]), flush=True)

    for name in backends:
        agg = fns[name]
        with torch.no_grad():
            emit("spmm_fwd", name, lambda: agg(g, x))
        if args.grad:
            xg = x.detach().requires_grad_(True)
            emit("spmm_fwd_bwd", name, lambda: torch.autograd.grad(
                agg(g, xg).pow(2).sum(), xg)[0])
    common.write_json(args.out, rows)
    return rows


if __name__ == "__main__":
    main()
