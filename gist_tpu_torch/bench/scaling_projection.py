"""The D-device scaling projection of one aggregation
(``benchmarks/scaling_projection.py``).

    python -m gist_tpu_torch.bench.scaling_projection
        --link-bytes-per-s RATE --link-name NAME [--t1-ms FP32 BF16]
        [--dataset synth-reddit-small] [--device cuda|cpu]
        [--out results/torch_scaling_projection.json]

A projection, not a measurement of several cards: the JAX script's model
(``ShardedGraph.projected_scaling``) shards the graph over D = 2, 4 and
8 ranks with the real partitioner and combines the slowest rank's edge
share of a one-device aggregation time with the halo rows it sends per
ring shift over one link.  Its two inputs are this run's:

* *t1*, the one-device aggregation time at fp32 and bf16: K1's forward
  on the flat layout, measured here by :func:`.spmm.k1_fwd_ms`
  (:func:`timing.kernel_ms`; ``t1_source`` says so).  ``--t1-ms``
  overrides both, and then ``t1_source`` reads ``--t1-ms``.  There is
  no default time.
* the link rate, ``--link-bytes-per-s``, and what link it is,
  ``--link-name``: both required, so a record always names the link
  it assumed.  :func:`ring_shift_rate` measures one, the bytes/s of a
  ring exchange of a rank's halo rows, in a world of ranks.

One JSON line with the JAX keys (``dataset``, ``f``, ``t1_agg_ms_fp32``,
``t1_agg_ms_bf16``, ``projections``: per D ``n_devices``,
``edge_balance``, ``ring_waste``, ``wire_bytes_per_device_fp32``,
``efficiency_overlap_fp32``, ``efficiency_serial_fp32``,
``efficiency_overlap_bf16``, ``projected_edges_per_s_fp32``), the JAX
``ici_bytes_per_s`` as ``link_bytes_per_s`` beside ``link_name``, plus
``t1_source``, the card's name and power limit and ``kernel_launches``.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from gist_tpu_torch.bench import common
from gist_tpu_torch.bench.spmm import k1_fwd_ms

DEFAULT_OUT = common.results_path("scaling_projection")
DEVICES = (2, 4, 8)


def projection_rows(ds, t1_fp32_s: float, t1_bf16_s: float,
                    link_bytes_per_s: float, devices=DEVICES) -> list:
    """The JAX script's row for each D: the graph sharded with the real
    partitioner, projected at fp32 (t1 ``t1_fp32_s``) and at bf16 (t1
    ``t1_bf16_s``, 2-byte rows on the wire)."""
    from gist_tpu_torch.parallel import build_sharded_graph
    f = int(ds.features.shape[1])
    rows = []
    for d in devices:
        sg = build_sharded_graph(ds.senders, ds.receivers, ds.n_nodes, d,
                                 interior_tiles=False)
        cs = sg.comm_stats(f=f)
        p32 = sg.projected_scaling(t1_fp32_s, f,
                                   link_bytes_per_s=link_bytes_per_s)
        p16 = sg.projected_scaling(t1_bf16_s, f, itemsize=2,
                                   link_bytes_per_s=link_bytes_per_s)
        rows.append({
            "n_devices": d,
            "edge_balance": p32["edge_balance"],
            "ring_waste": cs["ring_waste"],
            "wire_bytes_per_device_fp32": p32["wire_bytes_per_device"],
            "efficiency_overlap_fp32": p32["efficiency_overlap"],
            "efficiency_serial_fp32": p32["efficiency_serial"],
            "efficiency_overlap_bf16": p16["efficiency_overlap"],
            "projected_edges_per_s_fp32":
                ds.senders.shape[0] / p32["t_step_overlap_s"],
        })
    return rows


def run(ds, device, *, link_bytes_per_s: float, link_name: str,
        t1_ms=None, devices=DEVICES, iters: int = 10) -> dict:
    """The record on ``ds``: t1 measured on ``device`` unless ``t1_ms``
    (fp32, bf16) is given."""
    if not (link_bytes_per_s and link_bytes_per_s > 0) or not link_name:
        raise ValueError("the projection needs a link rate (bytes/s) and "
                         "the name of the link it is")
    dev = torch.device(device)
    before = common.launch_counts()
    if t1_ms is None:
        t1 = k1_fwd_ms(ds, dev, iters=iters)
        source = (f"K1 forward on {ds.name}'s flat layout, measured in "
                  f"this run (timing.kernel_ms on {dev.type})")
    else:
        t1 = dict(zip(("float32", "bfloat16"), (float(v) for v in t1_ms)))
        source = "--t1-ms"
    rec = {"dataset": ds.name, "f": int(ds.features.shape[1]),
           "n_edges": int(len(ds.senders)),
           "t1_agg_ms_fp32": t1["float32"], "t1_agg_ms_bf16": t1["bfloat16"],
           "t1_source": source, "link_bytes_per_s": float(link_bytes_per_s),
           "link_name": link_name, **common.hardware(dev)}
    rec["projections"] = projection_rows(
        ds, t1["float32"] / 1e3, t1["bfloat16"] / 1e3, link_bytes_per_s,
        devices)
    rec["kernel_launches"] = common.launches_since(before)
    return rec


def ring_shift_rate(sg, mesh, x_loc: torch.Tensor, iters: int = 10) -> dict:
    """Bytes/s of one ring exchange of this rank's halo rows of
    ``x_loc`` (``parallel/graph_shard.py:ring_halo``, every kept shift
    posted at once), over the mesh's ``graph`` dim: the rows it sends
    (``sum(ring_pads)`` at ``x_loc``'s width and dtype) over the median
    wall of ``iters`` exchanges, each between two synchronisations of
    the card (the host's clock: under gloo a CUDA payload is staged
    through host memory, and that copy is part of the link)."""
    from gist_tpu_torch.parallel.graph_shard import (ring_device_arrays,
                                                     ring_halo)
    rank = mesh.get_local_rank("graph")
    group = mesh.get_group("graph")
    arrays = ring_device_arrays(sg, rank, x_loc.device)
    nbytes = sum(sg.ring_pads) * x_loc.shape[1] * x_loc.element_size()
    cuda = x_loc.is_cuda
    times = []
    with torch.no_grad():
        for i in range(iters + 1):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            ring_halo(sg, x_loc, arrays, group)
            if cuda:
                torch.cuda.synchronize()
            if i:                                  # the first warms up
                times.append(time.perf_counter() - t0)
    s = statistics.median(times)
    return {"bytes_per_shift_exchange": int(nbytes), "seconds": s,
            "bytes_per_s": nbytes / s, "iters": iters,
            "backend": torch.distributed.get_backend(group),
            "ranks": torch.distributed.get_world_size(group)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--link-bytes-per-s", type=float, required=True,
                   help="the link's rate, bytes/s (no default)")
    p.add_argument("--link-name", required=True,
                   help="what link that rate is, for the record")
    p.add_argument("--t1-ms", type=float, nargs=2, default=None,
                   metavar=("FP32", "BF16"),
                   help="one-device aggregation ms (JAX argv[1:3]); "
                        "default: K1 measured in this run")
    p.add_argument("--dataset", default="synth-reddit-small")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)

    def go():
        from gist_tpu_torch.data import load_dataset
        from gist_tpu_torch.utils import resolve_device
        rec = run(load_dataset(args.dataset), resolve_device(args.device),
                  link_bytes_per_s=args.link_bytes_per_s,
                  link_name=args.link_name, t1_ms=args.t1_ms)
        common.write_json(args.out, rec)
        return rec

    return common.script_main(go)


if __name__ == "__main__":
    raise SystemExit(main())
