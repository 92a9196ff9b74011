"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (it needs
no JAX).  Phases, each printing one JSON line with its seconds and
raising on failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of the port compiled from ``gist_tpu_torch/csrc``
   with nvcc, all sources at once;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the shapes of one real batch of the main path (synth-amazon2m-small,
   psize 50, batch 10), forward and backward, with times;
4. reference: gradients and three training steps of a flagship
   sub-model through K1 and through the segment path must agree;
5. main path: sequential ultra-wide GIST, SAGE h2048 K=8 with 4 hidden
   layers, 2 rounds x 8 subnets x 5 steps, counting K1 launches;
6. Cluster-GCN: one epoch of SAGE h256 with 2 layers on the same
   clusters, counting K1 launches.

Then the kernel summary line, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero without a card or
without the package beside it.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase_device(torch):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(out.stdout.strip(), flush=True)
    return {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build():
    """One nvcc per kernel source, all started together."""
    from gist_tpu_torch.ops import dedup_spmm
    builders = [dedup_spmm]
    os.makedirs(dedup_spmm.BUILD_DIR, exist_ok=True)
    t0 = time.time()
    procs = []
    for mod in builders:
        tmp = f"{mod.LIBRARY}.{os.getpid()}.tmp"
        procs.append((mod, tmp, subprocess.Popen(
            mod.build_command(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    for mod, tmp, p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {mod.SOURCE}:\n{err}")
        os.replace(tmp, mod.LIBRARY)
        regs = [ln.strip() for ln in err.splitlines() if "registers" in ln]
        emit({"phase": "build", "source": os.path.relpath(mod.SOURCE, HERE),
              "ptxas": regs})
    return time.time() - t0


def _median_ms(torch, fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _k1_bound(torch, layout, x, n_out_rows):
    """Least time for the function on these inputs: every input byte
    read once and output byte written once (real jobs only), against
    the useful multiply-adds of W's nonzero counts."""
    jobs = int(layout.job_offsets[-1])
    f, item = x.shape[1], x.element_size()
    nbytes = (jobs * layout.tile_rows * layout.cu        # W counts, int8
              + jobs * layout.cu * 4                     # u_senders
              + layout.job_offsets.numel() * 4
              + x.numel() * item + n_out_rows * f * item)
    nnz = int(torch.count_nonzero(layout.w_blocks[:jobs]))
    flops = 2 * nnz * f
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(x.dtype).split(".")[-1]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def _csr_adjacency(torch, graph, dtype, device, transpose):
    """A[r, s] = count of edge s->r (rows in kernel output order, which
    is node order for the sampler's unreordered layouts)."""
    e = graph.n_edges
    s, r = graph.senders[:e].long(), graph.receivers[:e].long()
    if transpose:
        s, r = r, s
    n = graph.n_nodes
    a = torch.sparse_coo_tensor(torch.stack([r, s]),
                                torch.ones(e, dtype=torch.float32),
                                (n, n)).coalesce()
    return a.to(dtype).to(device).to_sparse_csr()


def phase_kernels(torch, device, sampler):
    import numpy as np

    from gist_tpu_torch.ops import dedup_spmm as K

    batch = sampler.make_batch(next(sampler.iter_node_ids()))
    g = batch.graph
    if g.dedup is None or g.dedup.pos is not None:
        raise RuntimeError("expected an unreordered dedup layout")
    layouts = {"fwd": g.dedup.to(device), "bwd": g.dedup_t.to(device)}
    emit({"phase": "kernels", "batch_nodes": batch.n_real_nodes,
          "batch_edges": batch.n_real_edges, "n_pad": g.n_nodes,
          "tiles": g.dedup.num_tiles,
          "jobs": int(g.dedup.job_offsets[-1]),
          "w_blocks": list(g.dedup.w_blocks.shape),
          "w_nonzero": int(torch.count_nonzero(g.dedup.w_blocks))})
    rng = np.random.default_rng(0)
    results = {}
    for f, dtype in ((100, torch.float32), (256, torch.float32),
                     (256, torch.bfloat16)):
        x = torch.from_numpy(
            rng.standard_normal((g.n_nodes, f)).astype(np.float32))
        x = x.to(dtype).to(device)
        for direction, lay in layouts.items():
            def kernel():
                return K.dedup_spmm(lay.job_offsets, lay.w_blocks,
                                    lay.u_senders, x)

            def plain():
                return K.dedup_spmm_reference(lay.job_offsets, lay.w_blocks,
                                              lay.u_senders, x)
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise RuntimeError("K1 output is not finite")
            abs_err = float((got.float() - want.float()).abs().max())
            rel_err = abs_err / float(want.float().abs().max())
            tol = 1e-5 if dtype == torch.float32 else 1e-2
            bound_ms, bound_by, nbytes, flops = _k1_bound(
                torch, lay, x, got.shape[0])
            adj = _csr_adjacency(torch, g, dtype, device,
                                 transpose=direction == "bwd")
            try:
                library_ms = _median_ms(
                    torch, lambda: torch.sparse.mm(adj, x), reps=10)
            except RuntimeError as e:   # no such library call for dtype
                library_ms, lib_note = None, str(e).splitlines()[0]
            else:
                lib_note = "torch.sparse.mm on a CSR adjacency"
            row = {"phase": "kernels", "case": f"{direction} F={f} "
                   f"{str(dtype).split('.')[-1]}",
                   "max_abs_err": abs_err, "rel_err": rel_err, "tol": tol,
                   "ms": _median_ms(torch, kernel, reps=20),
                   "plain_ms": _median_ms(torch, plain, reps=3),
                   "library_ms": library_ms, "library": lib_note,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_bytes": nbytes, "useful_flops": flops}
            emit(row)
            if not rel_err <= tol:
                raise RuntimeError(f"K1 disagrees with its plain version: "
                                   f"{row}")
            results[row["case"]] = row
    return results


def phase_reference(torch, device, sampler):
    """One flagship sub-model (width 256, four hidden layers, dropout 0)
    on real batches, through K1 and through the segment path (gather +
    index_add): the first step's parameter gradients and the losses of
    three Adam steps must agree.  Trained weights are not compared:
    Adam's g / (sqrt(v) + eps) turns summation-order noise in near-zero
    gradients into steps of size lr."""
    from gist_tpu_torch.ist.ultrawide import build_local_burst_single
    from gist_tpu_torch.models import sage
    from gist_tpu_torch.models.common import masked_cross_entropy
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.ops import spmm
    from gist_tpu_torch.sampler import ClusterSampler
    from gist_tpu_torch.train.ist_cluster import (_batches_to_device,
                                                  _RoundCollector)

    cfg = sage.SAGEConfig(100, 2048, 47, n_layers=4, dropout=0.0)
    sub_cfg = cfg.sub_config(split_input=False, split_output=True,
                             num_subnet=8)
    batches = _batches_to_device(
        _RoundCollector(sampler, 3, ids_only=True).collect(), device)
    if not all(b.graph.dedup is not None for b in batches):
        raise RuntimeError("reference batches lack a dedup layout")
    tables = sampler.tables(device)
    burst = build_local_burst_single(sage, sub_cfg, weight_decay=5e-4)
    init = sage.init(torch.Generator().manual_seed(0), sub_cfg)

    def fresh():
        return {"layers": [{k: v.to(device, copy=True) for k, v in l.items()}
                           for l in init["layers"]]}

    out = {}
    for backend in ("dedup", "segment"):
        spmm.set_default_backend(backend)
        K.launches = 0
        sub = fresh()
        leaves = [t.requires_grad_(True)
                  for l in sub["layers"] for t in l.values()]
        graph, feats, labels, mask = ClusterSampler.resolve_batch(
            batches[0], tables)
        loss = masked_cross_entropy(
            sage.apply(sub, graph, feats, sub_cfg, train=True), labels, mask)
        grads = torch.autograd.grad(loss, leaves)
        _, losses = burst(fresh(), batches, 1e-2, None, tables)
        out[backend] = (grads, losses.cpu(), K.launches)
    spmm.set_default_backend("auto")
    (kg, kl, kn), (sg, sl, sn) = out["dedup"], out["segment"]
    g_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in
                zip(kg, sg))
    row = {"phase": "reference", "steps": len(batches),
           "losses_k1": kl.tolist(), "losses_segment": sl.tolist(),
           "grad_rel_err": g_err, "k1_launches": kn}
    emit(row)
    if kn != 9 * (1 + len(batches)) or sn != 0:
        raise RuntimeError(f"unexpected K1 launches: {row}")
    # summation order is the only difference: fp32 agreement to 1e-4
    if not (torch.allclose(kl, sl, rtol=1e-4, atol=1e-5) and g_err <= 1e-4):
        raise RuntimeError(f"K1 training disagrees with the segment path: "
                           f"{row}")


def phase_main_path(torch, ds):
    from gist_tpu_torch.models.sage import SAGEConfig
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.ist_ultrawide import train_ist_ultrawide

    cfg = SAGEConfig(100, 2048, 47, n_layers=4, dropout=0.2)
    tc = TrainConfig(lr=1e-2, weight_decay=0.0, n_epochs=16, num_subnet=8,
                     iter_per_site=5)
    n_rounds = 2
    K.launches = 0
    r = train_ist_ultrawide(ds, cfg, tc, psize=50, batch_size=10,
                            normalize=True, use_f1=True, eval_on_cpu=False,
                            eval_every_rounds=n_rounds, verbose=False,
                            device="cuda")
    torch.cuda.synchronize()
    launches = K.launches
    steps = len(r["losses"]) * tc.num_subnet * tc.iter_per_site
    emit({"phase": "main_path", "rounds": len(r["losses"]), "steps": steps,
          "losses": r["losses"], "round_wall_s": r["round_wall_s"],
          "host_prep_s": r["host_prep_s"],
          "device_sync_s": r["device_sync_s"], "val_f1": r["val_accs"],
          "test_f1": r["test_accs"], "eval_wall_s": r["eval_wall_s"],
          "edges_per_batch": r["edges_per_batch"], "k1_launches": launches})
    if len(r["losses"]) != n_rounds or steps != 80:
        raise RuntimeError(f"expected 2 rounds of 40 steps, got {steps}")
    if launches != 9 * steps:
        raise RuntimeError(f"K1 launched {launches} times, want 9 per step "
                           f"({9 * steps}): some batch skipped the kernel")
    if not all(e >= 200_000 for e in r["edges_per_batch"]):
        raise RuntimeError("a batch fell under the layout's edge threshold")
    if not all(map(lambda v: v == v and abs(v) < float("inf"),
                   r["losses"] + r["val_accs"])):
        raise RuntimeError("non-finite loss or accuracy")
    return launches


def phase_cluster_gcn(torch, ds):
    from gist_tpu_torch.models.sage import SAGEConfig
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.train.cluster import train_cluster_gcn
    from gist_tpu_torch.train.common import TrainConfig

    cfg = SAGEConfig(100, 256, 47, n_layers=2, dropout=0.2)
    tc = TrainConfig(lr=1e-2, weight_decay=0.0, n_epochs=1)
    K.launches = 0
    r = train_cluster_gcn(ds, cfg, tc, psize=50, batch_size=10,
                          normalize=True, use_f1=True, verbose=False,
                          device="cuda")
    torch.cuda.synchronize()
    launches = K.launches
    emit({"phase": "cluster_gcn", "steps": 5, "losses": r["losses"],
          "val_f1": r["val_accs"], "train_time_s": r["train_time"],
          "k1_launches": launches})
    if launches != 5 * 5:
        raise RuntimeError(f"K1 launched {launches} times, want 25")
    if not all(v == v and abs(v) < float("inf") for v in r["losses"]):
        raise RuntimeError("non-finite loss")


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available")
    if not os.path.isdir(os.path.join(HERE, "gist_tpu_torch")):
        sys.exit("chip_smoke: run from a checkout holding gist_tpu_torch/")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_all = time.time()

    t0 = time.time()
    dev = phase_device(torch)
    emit({"phase": "device", **dev, "seconds": time.time() - t0})

    emit({"phase": "build", "seconds": phase_build()})

    import dataclasses

    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.sampler import ClusterSampler
    ds = load_dataset("synth-amazon2m-small")
    sampler = ClusterSampler(dataclasses.replace(ds), 50, 10, seed=0,
                             tiles=True)

    t0 = time.time()
    cases = phase_kernels(torch, device, sampler)
    emit({"phase": "kernels", "seconds": time.time() - t0})

    t0 = time.time()
    phase_reference(torch, device, sampler)
    emit({"phase": "reference", "seconds": time.time() - t0})

    t0 = time.time()
    launches = phase_main_path(torch, dataclasses.replace(ds))
    emit({"phase": "main_path", "seconds": time.time() - t0})

    t0 = time.time()
    phase_cluster_gcn(torch, dataclasses.replace(ds))
    emit({"phase": "cluster_gcn", "seconds": time.time() - t0})

    main_case = cases["fwd F=256 float32"]
    emit({"kernels": [{
        "name": "dedup_spmm", "route": "cuda",
        "source": "gist_tpu_torch/csrc/dedup_spmm.cu",
        "replaces": "gist_tpu/ops/pallas_spmm.py:66",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()
                           if c["case"].endswith("float32")),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]})
    emit({"phase": "total", "seconds": time.time() - t_all})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})


if __name__ == "__main__":
    main()
