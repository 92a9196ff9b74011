"""The sharded aggregation and the sharded GCN forward on a world of one
(``benchmarks/sharded_step_bench.py``, ``benchmarks/sharded_gcn_bench.py``).

    python -m gist_tpu_torch.bench.sharded [--dataset synth-reddit-small]
        [--link-bytes-per-s RATE --link-name NAME]
        [--device cuda|cpu] [--out results/torch_sharded.json]

At D=1 there is no halo and every edge is interior, so what this
measures is the sharding's own cost against the flat path.  The world
of one is ``nccl`` on the card and ``gloo`` on the CPU; a caller that
already holds a process group (``chip_smoke.py``) calls
:func:`step_bench` and :func:`gcn_bench` with its own mesh.

* step (``sharded_step_bench.py``): the flat K1 aggregation (F=602,
  forward layout), the sharded ring aggregation with interior K1 tiles,
  and the ring on the segment path (``interior_tiles=False``), each
  sharded one with its error against the flat one relative to its max.
  Given a link rate (``--link-bytes-per-s``, and ``--link-name`` for
  the record), the step record also carries the JAX script's projection
  to D = 2, 4 and 8 ranks from the sharded D=1 kernel time
  (``projected_scaling_from_sharded_step``, :func:`step_projection`);
  without one the key is absent: the projection has no default link.
* gcn (``sharded_gcn_bench.py``): GCN h128, 2 hidden layers, self
  loops, dropout 0: the flat forward (``models/gcn``, K1) against the
  sharded D=1 forward (whole-tensor LayerNorm over the ``graph`` dim).

Times are device time per call (:func:`timing.kernel_ms`).  One JSON
line for each part, with the JAX scripts' keys; both go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile

import numpy as np
import torch

from gist_tpu_torch.bench import common
from gist_tpu_torch.bench.timing import kernel_ms

DEFAULT_OUT = common.results_path("sharded")
GCN_HIDDEN, GCN_LAYERS = 128, 2


def _flat_graph(s, r, n, dev):
    from gist_tpu_torch.graph import graph_from_edges
    g = graph_from_edges(s, r, n, tiles=True)
    if g.dedup is None:
        raise RuntimeError("the flat dedup layout did not build")
    return g.replace(dedup_t=None).to(dev)


def step_bench(ds, mesh, dev):
    """(the step record, the sharded graph with interior tiles)."""
    from gist_tpu_torch.ops.spmm import aggregate
    from gist_tpu_torch.parallel import build_sharded_graph, sharded_aggregate
    from gist_tpu_torch.parallel.graph_shard import shard_features, unshard
    e, f = len(ds.senders), ds.in_feats
    g = _flat_graph(ds.senders, ds.receivers, ds.n_nodes, dev)
    x = torch.from_numpy(ds.features).to(dev)
    rec = {"dataset": ds.name, "n_edges": e, "f": f}
    with torch.no_grad():
        want = aggregate(g, x, backend="dedup")
        flat_ms = kernel_ms(lambda: aggregate(g, x, backend="dedup"),
                            device=dev)
        rec.update(flat_kernel_ms=flat_ms,
                   flat_edges_per_sec=e / flat_ms * 1e3)
        for tag, tiles in (("kernel", True), ("segment", False)):
            sg = build_sharded_graph(ds.senders, ds.receivers, ds.n_nodes,
                                     1, interior_tiles=tiles)
            if tiles and sg.int_dedup is None:
                raise RuntimeError("the D=1 sharded graph carries no tiles")
            xs = shard_features(sg, ds.features, 0, dev)
            agg = sharded_aggregate(sg, mesh)
            rec[f"sharded_d1_{tag}_rel_err"] = common.rel_err(
                unshard(sg, agg(xs)), want)
            rec[f"sharded_d1_{tag}_ms"] = kernel_ms(lambda: agg(xs),
                                                    device=dev)
            if tiles:
                sg_kernel = sg
    rec["sharded_vs_flat"] = rec["sharded_d1_kernel_ms"] / flat_ms
    return rec, sg_kernel


def step_projection(ds, t1_ms: float, link_bytes_per_s: float,
                    link_name: str) -> dict:
    """``projected_scaling_from_sharded_step``: for D = 2, 4 and 8 the
    graph sharded without interior layouts and projected from the
    sharded D=1 time ``t1_ms`` at ``link_bytes_per_s``
    (``ShardedGraph.projected_scaling``), with the overlap efficiency of
    a bf16 halo beside it, as the JAX script writes it; plus the link's
    rate and name."""
    from gist_tpu_torch.parallel import build_sharded_graph
    out = {"t1_ms": t1_ms, "link_bytes_per_s": float(link_bytes_per_s),
           "link_name": link_name}
    f = ds.in_feats
    for d in (2, 4, 8):
        sg = build_sharded_graph(ds.senders, ds.receivers, ds.n_nodes, d,
                                 interior_tiles=False)
        proj = sg.projected_scaling(t1_ms / 1e3, f,
                                    link_bytes_per_s=link_bytes_per_s)
        proj["efficiency_overlap_bf16_halo"] = sg.projected_scaling(
            t1_ms / 1e3, f, halo_itemsize=2,
            link_bytes_per_s=link_bytes_per_s)["efficiency_overlap"]
        out[f"d{d}"] = proj
    return out


def gcn_bench(ds, mesh, dev) -> dict:
    from gist_tpu_torch.models import gcn
    from gist_tpu_torch.parallel import build_sharded_graph
    from gist_tpu_torch.parallel.graph_shard import shard_features, unshard
    from gist_tpu_torch.parallel.train import device_arrays, sharded_forward
    # GCN trains with self loops, as the reference does
    loops = np.arange(ds.n_nodes)
    s = np.concatenate([ds.senders, loops])
    r = np.concatenate([ds.receivers, loops])
    e = len(s)
    cfg = gcn.GCNConfig(ds.in_feats, GCN_HIDDEN, ds.n_classes,
                        n_layers=GCN_LAYERS, dropout=0.0)
    params = gcn.init(torch.Generator().manual_seed(0), cfg)
    params = {"layers": [{k: v.to(dev) for k, v in layer.items()}
                         for layer in params["layers"]]}
    g = _flat_graph(s, r, ds.n_nodes, dev)
    x = torch.from_numpy(ds.features).to(dev)
    sg = build_sharded_graph(s, r, ds.n_nodes, 1, interior_tiles=True)
    xs = shard_features(sg, ds.features, 0, dev)
    arrays = device_arrays(sg, mesh)

    def flat():
        return gcn.apply(params, g, x, cfg, backend="dedup")

    def sharded():
        return sharded_forward("gcn", sg, params, xs, arrays,
                               use_layernorm=True)

    with torch.no_grad():
        err = common.rel_err(unshard(sg, sharded()), flat())
        flat_ms = kernel_ms(flat, device=dev)
        sh_ms = kernel_ms(sharded, device=dev)
    return {"dataset": ds.name, "n_edges": e, "f": ds.in_feats,
            "hidden": GCN_HIDDEN, "n_layers": GCN_LAYERS,
            "flat_fwd_ms": flat_ms, "sharded_d1_fwd_ms": sh_ms,
            "sharded_vs_flat": sh_ms / flat_ms, "sharded_rel_err": err,
            "edges_per_sec_flat": e / flat_ms * 1e3,
            "edges_per_sec_sharded_d1": e / sh_ms * 1e3,
            "note": "D=1: no halo, interior == all edges; the sharding's "
                    "plumbing and the whole-tensor LayerNorm's all_reduce "
                    "against the flat forward"}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="sharded paths at D=1")
    p.add_argument("--dataset", default="synth-reddit-small")
    p.add_argument("--link-bytes-per-s", type=float, default=None,
                   help="a link rate, bytes/s: adds the D-rank projection")
    p.add_argument("--link-name", default=None,
                   help="what link that rate is (needed with the rate)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)
    if (args.link_bytes_per_s is None) != (args.link_name is None):
        p.error("--link-bytes-per-s and --link-name go together")

    import torch.distributed as dist

    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.parallel import comm
    from gist_tpu_torch.utils import resolve_device

    dev = resolve_device(args.device)
    ds = load_dataset(args.dataset)
    work = tempfile.mkdtemp(prefix="bench_sharded_")
    dist.init_process_group(comm.default_backend(dev),
                            init_method=f"file://{work}/rdv", rank=0,
                            world_size=1)
    try:
        mesh = comm.make_mesh(dev.type, (1,), ("graph",))
        stamp = common.hardware(dev)
        out = {"step": {**step_bench(ds, mesh, dev)[0], **stamp},
               "gcn": {**gcn_bench(ds, mesh, dev), **stamp}}
        if args.link_bytes_per_s is not None:
            out["step"]["projected_scaling_from_sharded_step"] = \
                step_projection(ds, out["step"]["sharded_d1_kernel_ms"],
                                args.link_bytes_per_s, args.link_name)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    for part in out.values():
        print(json.dumps(part), flush=True)
    common.write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
