"""The GAT attention kernels against the segment composite, and the GAT
train step (``benchmarks/gat_bench.py``).

    python -m gist_tpu_torch.bench.gat [--nodes 4096] [--edges 80000]
        [--dim 128] [--iters 20] [--dataset NAME] [--layout gather|dedup]
        [--dtype float32|bfloat16] [--train-step] [--device cuda|cpu]
        [--out results/torch_gat.json]

The graph is uniform-random (``default_rng(0)``) or a synthetic
dataset's, with the ``dedup`` layout (K4, and K5 and K6 in the
backward) or the v1 ``gather`` layout (K7, and K8 and K9).  Without
``--train-step``: one attention (z (N, D), scores (N,), slope 0.01)
through the kernel and through the segment composite, ``ms`` device
time per call.  With it: a 2-layer GAT (hidden D, 2 heads, 16 classes,
cross-entropy on every node, Adam 1e-3) trained ``--iters`` steps after
3 warm-up steps from the same params under three configurations, as the
JAX script's: the kernel forward with the fused kernel backward
(``set_gat_backward("fused")``), the kernel forward with the backward
differentiated through the segment composite (``"xla"``), and the
segment backend; ``"fused"`` is set again afterwards.  Each line has
the JAX script's keys, and a train-step line also the first and last
timed step's losses and ``grad_norm_rel_err``: the first step's
gradients (the same params in every configuration) against the segment
backend's, per leaf the norm of the difference over the norm of the
segment gradient, the largest over the leaves.  Losses after Adam
steps say little of the gradients' scale (Adam's first steps are lr
times the sign of each entry); the gradients do.  All lines also go to
``--out``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gist_tpu_torch.bench import common
from gist_tpu_torch.bench.timing import kernel_ms, span_ms

DEFAULT_OUT = common.results_path("gat")
CONFIGS = (("kernel+fused-bwd", "dedup", "fused"),
           ("kernel+xla-bwd", "dedup", "xla"),
           ("segment", "segment", "fused"))


def train_steps(g, n: int, d: int, iters: int, dev) -> list:
    """The three train-step configurations' lines."""
    from gist_tpu_torch.models import gat
    from gist_tpu_torch.models.common import masked_cross_entropy
    from gist_tpu_torch.ops.gat_dedup import set_gat_backward
    from gist_tpu_torch.train.common import make_optimizer
    rng = np.random.default_rng(1)
    n_classes = 16
    cfg = gat.GATConfig(d, d, n_classes, n_layers=2, n_heads=2)
    init = gat.init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, n_classes, n)).to(dev)
    x, mask = x.to(dev), torch.ones(n, dtype=torch.bool, device=dev)
    rows, first = [], []
    try:
        for name, backend, bwd in CONFIGS:
            set_gat_backward(bwd)
            params = {"layers": [
                {k: v.clone().to(dev).requires_grad_(True)
                 for k, v in layer.items()} for layer in init["layers"]]}
            leaves = [t for layer in params["layers"]
                      for t in layer.values()]
            opt = make_optimizer(leaves, 1e-3, 0.0)
            losses, grads = [], []

            def step():
                opt.zero_grad(set_to_none=True)
                loss = masked_cross_entropy(
                    gat.apply(params, g, x, cfg, backend=backend),
                    labels, mask)
                loss.backward()
                if not grads:
                    grads.extend(t.grad.clone() for t in leaves)
                opt.step()
                losses.append(loss.detach())

            ms = span_ms(step, iters, device=dev)
            first.append(grads)
            rows.append({"op": "gat_train_step", "config": name, "N": n,
                         "E": g.n_edges, "D": d, "layers": 2, "heads": 2,
                         "ms_per_step": ms, "loss_first": float(losses[3]),
                         "loss_last": float(losses[-1])})
    finally:
        set_gat_backward("fused")
    for row, grads in zip(rows, first):
        row["grad_norm_rel_err"] = max(
            float((a - b).norm() / b.norm().clamp(min=1e-30))
            for a, b in zip(grads, first[-1]))
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description="GAT attention and train step")
    p.add_argument("--nodes", type=int, default=4096)
    p.add_argument("--edges", type=int, default=80000)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--dataset", default=None)
    p.add_argument("--layout", default="gather", choices=["gather", "dedup"])
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--train-step", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)

    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.ops.gat_dedup import gat_attention_dedup
    from gist_tpu_torch.ops.gat_tiled import gat_attention_tiled
    from gist_tpu_torch.ops.segment import gat_attention_segment
    from gist_tpu_torch.utils import resolve_device

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    d = args.dim
    if args.dataset:
        from gist_tpu_torch.data import load_dataset
        ds = load_dataset(args.dataset)
        s, r, n = ds.senders, ds.receivers, ds.n_nodes
    else:
        n, e = args.nodes, args.edges
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    g = graph_from_edges(s, r, n, tiles=True, tile_mode=args.layout)
    if (g.dedup if args.layout == "dedup" else g.tiled) is None:
        raise RuntimeError(f"the {args.layout} layout did not build")
    stamp = common.hardware(dev)
    rows = []
    if args.layout == "dedup":
        uniq = int(g.dedup.u_senders.numel())
        rows.append({"layout": "dedup", "N": n, "E": g.n_edges,
                     "unique_slots": uniq,
                     "dedup_ratio": uniq / g.n_edges})
        print(json.dumps(rows[-1]), flush=True)
    g = g.to(dev)

    if args.train_step:
        lines = train_steps(g, n, d, args.iters, dev)
    else:
        z = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
        z = z.to(getattr(torch, args.dtype)).to(dev)
        a = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        a, b = a.to(dev), b.to(dev)
        kernel = gat_attention_dedup if args.layout == "dedup" \
            else gat_attention_tiled
        lines = []
        for name, fn in ((f"kernel-{args.layout}", kernel),
                         ("segment", gat_attention_segment)):
            with torch.no_grad():
                ms = kernel_ms(lambda: fn(g, z, a, b, 0.01),
                               windows=args.iters, device=dev)
            lines.append({"op": "gat_attention", "backend": name, "N": n,
                          "E": g.n_edges, "D": d, "dtype": args.dtype,
                          "ms": ms, "edges_per_sec": g.n_edges / ms * 1e3})
    for line in lines:
        rows.append({**line, **stamp})
        print(json.dumps(rows[-1]), flush=True)
    common.write_json(args.out, rows)
    return rows


if __name__ == "__main__":
    main()
