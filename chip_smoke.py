"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (it needs
no JAX).  Phases, each printing one JSON line with its seconds and
raising on failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of the port compiled from ``gist_tpu_torch/csrc``
   with nvcc, all sources at once;
3. kernels: K1 against its plain PyTorch version on the card, at the
   shapes of one real batch of the SAGE main path (synth-amazon2m-small,
   psize 50, batch 10), forward and backward, with times;
4. reference: gradients and three training steps of a flagship
   sub-model through K1 and through the segment path must agree;
5. main path: sequential ultra-wide GIST, SAGE h2048 K=8 with 4 hidden
   layers, 2 rounds x 8 subnets x 5 steps, counting K1 launches;
6. Cluster-GCN: one epoch of SAGE h256 with 2 layers on the same
   clusters, counting K1 launches;
7. GAT kernels: K4, K5 and K6 against their plain versions at the shapes
   of one real batch of the GAT main path (synth-reddit-small, psize 10,
   batch 4), with times beside the segment composite's, each with its
   profiler time and two launches held bitwise equal;
8. GAT reference: gradients and three training steps of a GAT
   sub-model (width 256, 2 heads, 2 layers) through K4-K6 and through
   the segment path must agree;
9. GAT main path: ``train_ist_cluster`` with GAT h512, 2 heads, K=2,
   2 layers, 2 rounds x 2 subnets x 4 steps, counting K4-K6 launches;
   again under ``torch.profiler`` for its device time per step;
10. split kernels: K2 against its plain version on the
    synth-amazon2m-small split layouts (TN 64, threshold 128, CU 1024
    and 512), forward and transpose, F=100 fp32 and bf16 and F=47 fp32,
    with times;
11. split path: one GCN h256 training step through K2 on the split
    layouts and through K1 per chunk on the chunked layouts of the same
    graph must agree, counting K2 launches;
12. full-scale main path: ``train_full_graph``, GCN h256, 6 epochs on
    synth-reddit (46.8M edges with self loops) through the chunked
    layouts, counting K1 launches (4 C_f + 2 C_t per epoch); then K1 per
    chunk on those layouts, forward and transpose at F=256 and F=41,
    against its plain version and the segment aggregation, with times
    beside one ``torch.sparse.mm``;
13. chunked GAT: a full-graph GAT h512 (2 heads, 2 layers) forward on
    the same graph's chunked layout through K4 once per chunk and layer,
    against the segment path;
14. v1 kernels: K3 and K7-K9 against their plain versions on the v1
    gather layout (``TiledCSR``), at the shapes of one batch of
    ``ClusterSampler(synth-reddit-small, 10, 4, tile_mode="gather")``
    and at the full synth-reddit-small graph's (the v1 main path's),
    with times beside the bound, ``torch.sparse.mm`` (K3) and the
    segment composite (K7-K9), and the rate of the rows each walk
    gathers; K9 also beside one ``torch.sparse.mm`` of the transpose
    pattern with alpha in its values (its dz part alone); K3 and K7-K9
    also with their profiler time and two launches held bitwise equal;
    K3's launch plans side by side at F=41, 47 and 256 on the full
    graph, and K7's, K8's and K9's at D=41 and 512 (phase
    ``v1_gat_plans``: every plan, in rounds; K9's best plan with at most
    8 and with at most 16 accumulators a lane);
15. v1 reference: one GAT h512 (2 heads, 2 layers) and one GCN h256
    training run of two Adam steps on the full synth-reddit-small v1
    graph through K7-K9 or K3 and through the segment path must agree;
16. v1 main path: ``train_full_graph`` on that graph for 6 epochs with
    GAT h512 (K7-K9) and with GCN h256 (K3), counting launches; each
    again under ``torch.profiler`` for its device time per epoch;
17. uw_resume (run after phase 6): the main path's configuration with
    a checkpoint each round, 3 rounds uninterrupted, then 2 rounds into
    a fresh directory resumed to 3; the resumed tail's losses and val F1
    must equal the uninterrupted run's within 1e-5 relative, K1 9
    launches a step in every run;
18. uw_cli_chunked_eval (run last): ``python -m
    gist_tpu_torch.cli.ist_distrib --ultra-wide`` as a function, SAGE
    h2048, 4 hidden layers, K=8, 2 rounds on synth-reddit (psize 100,
    batch 10: K1 on every batch, 9 launches a step) with checkpoints and
    the chunked host eval; then ``cli.infer`` on the last round on the
    card, and the chunked host forward of the same params held against
    the card's logits at rtol = atol = 0.05, with both walls, the
    host's ``nproc`` and torch threads.

Kernel and library times: ``ms`` is device time per call, one CUDA
event pair around back-to-back calls queued ahead of the card
(:func:`_kernel_ms`); ``call_ms`` is one call between two events, the
wrapper's host work included (:func:`_call_ms`, the figure of earlier
runs).  Plain versions and model forwards keep one-call timing.

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
    from gist_tpu_torch.ops import (dedup_spmm, gat_dedup, gat_tiled,
                                    split_spmm, tiled_spmm)
    modules = [dedup_spmm, gat_dedup, split_spmm, tiled_spmm, gat_tiled]
    os.makedirs(dedup_spmm.BUILD_DIR, exist_ok=True)
    t0 = time.time()
    procs = []
    for mod in modules:
        lib = dedup_spmm.library_path(mod.SOURCE)
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs.append((mod, lib, tmp, subprocess.Popen(
            dedup_spmm.build_command(tmp, mod.SOURCE), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    for mod, lib, tmp, p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {mod.SOURCE}:\n{err}")
        os.replace(tmp, lib)
        entries = _ptxas_entries(err)
        emit({"phase": "build", "source": os.path.relpath(mod.SOURCE, HERE),
              "instances": len(entries),
              "registers": sorted({r for _, r, _ in entries}),
              "spill_store_bytes": {k: b for k, _, b in entries if b},
              "ptxas": [f"{k}: {r} registers" for k, r, _ in entries]})
    return time.time() - t0


def _ptxas_entries(report):
    """(instance, registers, spill store bytes) of each kernel instance in
    nvcc's ``-Xptxas -v`` report, an instance named by its kernel and
    template arguments (``tiled_gat_b1_kernel<f32,4,16,4,1>``)."""
    import re
    out, name, spill = [], None, 0
    for ln in report.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", ln)
        if found:
            mangled, spill = found.group(1), 0
            name = mangled
            # a mangled identifier is its length, then its characters
            end = mangled.find("_kernelI") + len("_kernel")
            for size in range(len("_kernel"), end if end > 7 else 0):
                if mangled[:end - size].endswith(str(size)):
                    args = re.match(r"I(\w*?)EE?v", mangled[end:]).group(1)
                    name = "{}<{}>".format(mangled[end - size:end], ",".join(
                        ["bf16" if "bfloat16" in args else "f32"]
                        * (args[:1] in "f1")
                        + re.findall(r"L[ib](\d+)E", args)))
                    break
            continue
        found = re.search(r"(\d+) bytes spill stores", ln)
        if found:
            spill = int(found.group(1))
            continue
        found = re.search(r"Used (\d+) registers", ln)
        if found and name:
            out.append((name, int(found.group(1)), spill))
            name = None
    return out


def _call_ms(torch, fn, reps, warmup=2):
    """Median milliseconds of one call between two CUDA events on an idle
    stream (``call_ms``): the wrapper's host work (its checks,
    allocations and the ctypes call) falls inside it.  Kept beside
    :func:`_kernel_ms` so that times of earlier runs stay comparable."""
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


def _kernel_ms(torch, fn, windows=5, window_ms=4.0):
    """Device milliseconds per call (``ms``): one CUDA event pair around
    n back-to-back calls, divided by n, the median of ``windows`` such
    windows; n makes a window last about ``window_ms``.  Before each
    window the stream sleeps for 1.5x the host time that n calls take to
    enqueue, so the host has queued every call before the first one
    starts and no host work falls between two launches."""
    fn()
    torch.cuda.synchronize()
    one = _call_ms(torch, fn, reps=3, warmup=0)
    n = max(1, min(2000, round(window_ms / max(one, 1e-3))))
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(enqueue_s * 1.5 * 2e9) + 1_000_000   # ~2 GHz SM clock
    times = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def _device_events(prof):
    """The device-side events (kernels, copies, sets) of a profile."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _profiled(torch, fn):
    """(fn's result, the ``torch.profiler`` trace of the call)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    return res, prof


def _profiled_ms(torch, fn, name, calls=5):
    """Mean device duration (ms) of the kernels whose name holds ``name``
    over ``calls`` calls of ``fn``, from one ``torch.profiler`` trace;
    None where the trace holds no such kernel."""
    fn()
    torch.cuda.synchronize()
    _, prof = _profiled(torch, lambda: [fn() for _ in range(calls)])
    durs = [e.time_range.elapsed_us() for e in _device_events(prof)
            if name in e.name]
    return sum(durs) / len(durs) / 1e3 if durs else None


def _device_split(prof, units, kernels):
    """Device time of a profiled run: busy (the sum of its device
    events, which one stream runs one after another), the span from the
    first event's start to the last one's end, the idle share of that
    span, busy per unit (step or epoch), and the device time per unit of
    the kernels whose names hold each of ``kernels`` (label -> name)."""
    ev = _device_events(prof)
    if not ev:
        return {"device_profile": "no device events in the trace"}
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    span = (max(e.time_range.end for e in ev)
            - min(e.time_range.start for e in ev)) / 1e3
    return {"device_busy_ms": busy, "device_span_ms": span,
            "device_idle_share": 1 - busy / span if span else None,
            "device_busy_ms_per_unit": busy / units,
            "kernel_ms_per_unit": {
                label: sum(e.time_range.elapsed_us() for e in ev
                           if name in e.name) / 1e3 / units
                for label, name in kernels.items()}}


def _bound(nbytes, flops, dtype):
    """(ms, what binds) of the least time for ``nbytes`` of traffic and
    ``flops`` operations at the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    return _bound(nbytes, flops, x.dtype) + (nbytes, flops)


def _grid(job_offsets, f, tile_rows):
    """Launch grid (feature slices, blocks per tile, tiles) and largest
    jobs per tile of K1 or K2 over ``job_offsets`` ((tiles + 1,) or one
    row per chunk): a hub tile sets a tail."""
    from gist_tpu_torch.ops.dedup_spmm import launch_grid
    per_tile = job_offsets[..., 1:] - job_offsets[..., :-1]
    return {"grid": list(launch_grid(per_tile.shape[-1], f, tile_rows)),
            "launches_per_pass": per_tile.numel() // per_tile.shape[-1],
            "max_jobs_per_tile": int(per_tile.max())}


def _csr_adjacency(torch, graph, dtype, device, transpose):
    """A[r, s] = count of edge s->r (rows in kernel output order, which
    is node order for the sampler's unreordered layouts)."""
    e = graph.n_edges
    s, r = graph.senders[:e].long().cpu(), graph.receivers[:e].long().cpu()
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
                library_call_ms = _call_ms(
                    torch, lambda: torch.sparse.mm(adj, x), reps=10)
            except RuntimeError as e:   # no such library call for dtype
                library_ms = library_call_ms = None
                lib_note = str(e).splitlines()[0]
            else:
                library_ms = _kernel_ms(torch,
                                        lambda: torch.sparse.mm(adj, x))
                lib_note = "torch.sparse.mm on a CSR adjacency"
            ms = _kernel_ms(torch, kernel)
            row = {"phase": "kernels", "case": f"{direction} F={f} "
                   f"{str(dtype).split('.')[-1]}",
                   "max_abs_err": abs_err, "rel_err": rel_err, "tol": tol,
                   "ms": ms, "call_ms": _call_ms(torch, kernel, reps=20),
                   "plain_ms": _call_ms(torch, plain, reps=3),
                   "library_ms": library_ms,
                   "library_call_ms": library_call_ms, "library": lib_note,
                   "ms_over_library": library_ms and ms / library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_bytes": nbytes, "useful_flops": flops,
                   **_grid(lay.job_offsets, f, lay.tile_rows)}
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
    gradients into steps of size lr.

    The gradients are held per leaf by the norm of the difference
    relative to the segment gradient's norm, at 1e-3.  A max-relative
    bar is not well posed here: last-bit summation noise flips the sign
    of a ReLU input now and then (one among the 5.2M of this batch),
    and that alone moves the first two layers' gradients by up to
    ~5e-4 max-relative and ~1.5e-4 norm-wise, the segment path against
    itself with its edge order reversed included.  A wrong aggregation
    moves them by O(1)."""
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

    def first_grads(batch):
        sub = fresh()
        leaves = [t.requires_grad_(True)
                  for l in sub["layers"] for t in l.values()]
        graph, feats, labels, mask = ClusterSampler.resolve_batch(
            batch, tables)
        loss = masked_cross_entropy(
            sage.apply(sub, graph, feats, sub_cfg, train=True), labels, mask)
        return torch.autograd.grad(loss, leaves)

    def errors(a_list, b_list):
        return ([float((a - b).norm() / b.norm())
                 for a, b in zip(a_list, b_list)],
                [float((a - b).abs().max() / b.abs().max())
                 for a, b in zip(a_list, b_list)])

    out = {}
    for backend in ("dedup", "segment"):
        spmm.set_default_backend(backend)
        K.launches = 0
        grads = first_grads(batches[0])
        _, losses = burst(fresh(), batches, 1e-2, None, tables)
        out[backend] = (grads, losses.cpu(), K.launches)
    # the segment path against itself, its edges summed in reverse order
    g0 = batches[0].graph
    flipped = batches[0].replace(graph=g0.replace(**{
        k: getattr(g0, k).flip(0).contiguous()
        for k in ("senders", "receivers", "t_senders", "t_receivers")}))
    rev_err, rev_max = errors(first_grads(flipped), out["segment"][0])
    spmm.set_default_backend("auto")
    (kg, kl, kn), (sg, sl, sn) = out["dedup"], out["segment"]
    norm_err, max_err = errors(kg, sg)
    g_err = max(norm_err)
    row = {"phase": "reference", "steps": len(batches),
           "losses_k1": kl.tolist(), "losses_segment": sl.tolist(),
           "grad_norm_rel_err": g_err, "grad_norm_rel_err_per_leaf": norm_err,
           "grad_max_rel_err_per_leaf": max_err,
           "segment_reversed_norm_rel_err": max(rev_err),
           "segment_reversed_max_rel_err": max(rev_max), "k1_launches": kn}
    emit(row)
    if kn != 9 * (1 + len(batches)) or sn != 0:
        raise RuntimeError(f"unexpected K1 launches: {row}")
    # summation order is the only difference: losses to 1e-4, gradients
    # to 1e-3 norm-wise (see above)
    if not (torch.allclose(kl, sl, rtol=1e-4, atol=1e-5) and g_err <= 1e-3):
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


def _rel_diff(a, b):
    """Largest |a - b| / max(|b|, tiny) over two equal-length lists."""
    return max((abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b)),
               default=0.0)


def phase_uw_resume(torch, ds):
    """Checkpoint and resume on the card: the SAGE main path's
    configuration with an eval on the card every round and a checkpoint
    each; 3 rounds uninterrupted, then 2 rounds into a fresh directory
    and that directory resumed to 3.  The cut run and the resumed tail
    must equal the uninterrupted run within 1e-5 relative (K1 sums in a
    fixed order); every run launches K1 9 times a step."""
    import dataclasses
    import tempfile

    from gist_tpu_torch.models.sage import SAGEConfig
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.train.checkpoint import latest_round_dir
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.ist_ultrawide import train_ist_ultrawide

    cfg = SAGEConfig(100, 2048, 47, n_layers=4, dropout=0.2)
    launches = 0

    def run(n_epochs, ck):
        nonlocal launches
        tc = TrainConfig(lr=1e-2, weight_decay=0.0, n_epochs=n_epochs,
                         num_subnet=8, iter_per_site=5)
        K.launches = 0
        t0 = time.time()
        r = train_ist_ultrawide(dataclasses.replace(ds), cfg, tc, psize=50,
                                batch_size=10, normalize=True, use_f1=True,
                                eval_on_cpu=False, checkpoint_dir=ck,
                                verbose=False, device="cuda")
        torch.cuda.synchronize()
        r["wall_s"] = time.time() - t0
        steps = len(r["round_wall_s"]) * tc.num_subnet * tc.iter_per_site
        if K.launches != 9 * steps:
            raise RuntimeError(f"K1 launched {K.launches} times in "
                               f"{steps} steps, want 9 per step")
        launches += K.launches
        r["k1_launches"] = K.launches
        return r

    with tempfile.TemporaryDirectory() as tmp:
        full = run(24, os.path.join(tmp, "full"))
        ck = os.path.join(tmp, "cut")
        cut = run(16, ck)
        if os.path.basename(latest_round_dir(ck) or "") != "round_1":
            raise RuntimeError("the cut run left no round_1 checkpoint")
        resumed = run(24, ck)
    loss_diff = _rel_diff(cut["losses"] + resumed["losses"], full["losses"])
    f1_diff = _rel_diff(cut["val_accs"] + resumed["val_accs"],
                        full["val_accs"])
    row = {"phase": "uw_resume", "rounds": [len(full["losses"]),
                                            len(cut["losses"]),
                                            len(resumed["losses"])],
           "losses": full["losses"],
           "resumed_losses": resumed["losses"], "val_f1": full["val_accs"],
           "resumed_val_f1": resumed["val_accs"],
           "loss_rel_diff": loss_diff, "val_f1_rel_diff": f1_diff,
           "tol": 1e-5, "k1_launches": launches,
           "k1_launches_by_run": [full["k1_launches"], cut["k1_launches"],
                                  resumed["k1_launches"]],
           "wall_s": [full["wall_s"], cut["wall_s"], resumed["wall_s"]],
           "round_wall_s": full["round_wall_s"],
           "eval_wall_s": full["eval_wall_s"],
           "resumed_round_wall_s": resumed["round_wall_s"]}
    emit(row)
    if [len(full["losses"]), len(cut["losses"]),
            len(resumed["losses"])] != [3, 2, 1]:
        raise RuntimeError(f"expected 3, 2 and 1 rounds: {row['rounds']}")
    if not (loss_diff <= 1e-5 and f1_diff <= 1e-5):
        raise RuntimeError("the resumed run left the uninterrupted one")
    if not all(v == v and abs(v) < float("inf")
               for v in full["losses"] + full["val_accs"]):
        raise RuntimeError("non-finite loss or F1")
    return launches


def phase_uw_cli_chunked_eval(torch, device):
    """The entry point and the serving path: ``cli.ist_distrib
    --ultra-wide`` trains SAGE h2048 (4 hidden layers, K=8) for 2 rounds
    on synth-reddit with checkpoints; N x h is over the trainer's
    threshold, so each eval runs the chunked host forward (its output is
    kept as it returns).  Then ``cli.infer`` evaluates the last round on
    the card with the plain ``sage.apply``, and the trainer's last
    chunked host forward, of the same params, is held against the card's
    logits at rtol = atol = 0.05."""
    import tempfile

    import numpy as np

    from gist_tpu_torch.cli import infer, ist_distrib
    from gist_tpu_torch.convert import params_from_jax
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.models import sage
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.sampler import TILES_MIN_EDGES
    from gist_tpu_torch.train import ist_ultrawide as UW
    from gist_tpu_torch.train.checkpoint import (latest_round_dir,
                                                 load_checkpoint,
                                                 params_to_host)

    model = ["--dataset", "synth-reddit", "--n-hidden", "2048",
             "--n-layers", "4", "--normalize", "--use-f1"]
    chunked, real = [], sage.apply_chunked_host

    def keep(*args, **kw):
        chunked.append(real(*args, **kw))
        return chunked[-1]

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        K.launches = 0
        t0 = time.time()
        sage.apply_chunked_host = keep
        try:
            r = ist_distrib.main(model + [
                "--ultra-wide", "--num_subnet", "8", "--iter_per_site", "5",
                "--psize", "100", "--batch-size", "10", "--n-epochs", "8",
                "--lr", "1e-2", "--dropout", "0.2", "--weight-decay", "0",
                "--checkpoint-dir", ck])
        finally:
            sage.apply_chunked_host = real
        torch.cuda.synchronize()
        train_wall = time.time() - t0
        launches = K.launches
        steps = len(r["round_wall_s"]) * 8 * 5
        logits_path = os.path.join(tmp, "logits.npy")
        t0 = time.time()
        served = infer.main(model + ["--checkpoint-dir", ck,
                                     "--logits-out", logits_path])
        infer_wall = time.time() - t0
        card = np.load(logits_path)
        params = params_to_host(load_checkpoint(latest_round_dir(ck))
                                ["params"])

    if len(chunked) != 2:
        raise RuntimeError(f"the trainer ran {len(chunked)} chunked evals, "
                           f"want one a round")
    host = chunked[-1]
    ds = load_dataset("synth-reddit").normalize_features()
    cfg = sage.SAGEConfig(ds.in_feats, 2048, ds.n_classes, n_layers=4)
    graph = graph_from_edges(ds.senders, ds.receivers, ds.n_nodes).to(device)
    x = torch.from_numpy(ds.features).to(device)
    p_dev = params_from_jax(params, device)
    device_eval_s = []                 # a first call, then a second
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.time()
            sage.apply(p_dev, graph, x, cfg)
            torch.cuda.synchronize()
            device_eval_s.append(time.time() - t0)
    del graph, x, p_dev
    err = np.abs(host - card)
    excess = float((err / (0.05 + 0.05 * np.abs(card))).max())
    nproc = subprocess.run(["nproc"], capture_output=True, text=True)
    row = {"phase": "uw_cli_chunked_eval", "nodes": ds.n_nodes,
           "edges": ds.n_edges,
           "activation_elements": ds.n_nodes * 2048,
           "chunked_threshold": UW.CHUNKED_EVAL_MIN_ELEMENTS,
           "rounds": len(r["losses"]), "steps": steps,
           "k1_launches": launches, "losses": r["losses"],
           "val_f1": r["val_accs"], "served_val_f1": served["val"],
           "round_wall_s": r["round_wall_s"],
           "host_prep_s": r["host_prep_s"],
           "device_sync_s": r["device_sync_s"],
           "trainer_eval_wall_s": r["eval_wall_s"],
           "rss_gb": r["rss_gb"], "loadavg_1m": r["loadavg_1m"],
           "edges_per_batch": r["edges_per_batch"],
           "cli_train_wall_s": train_wall, "cli_infer_wall_s": infer_wall,
           "host_eval_s": r["eval_wall_s"][-1],
           "device_eval_s": device_eval_s,
           "max_abs_err": float(err.max()),
           "tol_ratio": excess, "rtol": 0.05, "atol": 0.05,
           "argmax_agree": float((host.argmax(-1) == card.argmax(-1))
                                 .mean()),
           "nproc": int(nproc.stdout.strip() or 0),
           "torch_threads": torch.get_num_threads()}
    emit(row)
    if ds.n_nodes * 2048 <= UW.CHUNKED_EVAL_MIN_ELEMENTS:
        raise RuntimeError("synth-reddit at h2048 did not reach the "
                           "chunked eval")
    if len(r["losses"]) != 2:
        raise RuntimeError(f"expected 2 rounds with an eval each: {row}")
    if launches != 9 * steps:
        raise RuntimeError(f"K1 launched {launches} times, want 9 per step "
                           f"({9 * steps})")
    if not all(e >= TILES_MIN_EDGES for e in r["edges_per_batch"]):
        raise RuntimeError("a batch fell under the layout's edge threshold")
    if not (np.isfinite(host).all() and np.isfinite(card).all()
            and host.shape == card.shape == (ds.n_nodes, ds.n_classes)):
        raise RuntimeError("non-finite or misshapen logits")
    if excess > 1.0:
        raise RuntimeError(f"the chunked host eval left the card's logits: "
                           f"{excess:.3f} x the tolerance")
    return launches


def _layout_bytes(layout):
    """W of the real jobs, their slots and the tile offsets."""
    jobs = int(layout.job_offsets[-1])
    return (jobs * layout.tile_rows * layout.cu + jobs * layout.cu * 4
            + layout.job_offsets.numel() * 4)


def _nnz(torch, layout):
    return int(torch.count_nonzero(
        layout.w_blocks[:int(layout.job_offsets[-1])]))


def _outputs(res):
    return res if isinstance(res, (tuple, list)) else (res,)


def _redesign_checks(torch, kernel, kernel_name):
    """For a kernel redesigned to sum without atomics: its device time
    in one ``torch.profiler`` trace (cross-checks ``ms``) and whether two
    launches on the same inputs give the same bits."""
    first, second = _outputs(kernel()), _outputs(kernel())
    torch.cuda.synchronize()
    return {"profiler_ms": _profiled_ms(torch, kernel, kernel_name),
            "bitwise_repeat": all(torch.equal(a, b)
                                  for a, b in zip(first, second))}


def _gat_row(torch, name, case, got, want, tol, kernel, plain, segment,
             nbytes, flops, dtype, kernel_name=None):
    """Time a GAT kernel beside its plain version and the segment
    composite; raise unless every output is finite and within ``tol`` of
    the plain result relative to its max.  With ``kernel_name`` (a
    redesigned kernel) also its profiler time, and raise unless two
    launches give the same bits."""
    torch.cuda.synchronize()
    abs_err = rel_err = 0.0
    for a, b in zip(got, want):
        if not torch.isfinite(a.float()).all():
            raise RuntimeError(f"{name} {case}: output is not finite")
        err = float((a.float() - b.float()).abs().max())
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / float(b.float().abs().max()))
    bound_ms, bound_by = _bound(nbytes, flops, dtype)
    row = {"phase": "gat_kernels", "kernel": name, "case": case,
           "max_abs_err": abs_err, "rel_err": rel_err, "tol": tol,
           "ms": _kernel_ms(torch, kernel),
           "call_ms": _call_ms(torch, kernel, reps=20),
           "plain_ms": _call_ms(torch, plain, reps=3),
           "segment_ms": _kernel_ms(torch, segment),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_bytes": nbytes, "useful_flops": flops}
    if kernel_name:
        row.update(_redesign_checks(torch, kernel, kernel_name))
    emit(row)
    if not rel_err <= tol:
        raise RuntimeError(f"{name} disagrees with its plain version: {row}")
    if kernel_name and not row["bitwise_repeat"]:
        raise RuntimeError(f"{name}: two launches differ: {row}")
    return row


def phase_gat_kernels(torch, device, sampler):
    """K4 at (H=2, O=256) and (H=1, O=41), K5 and K6 for one head at
    O=256 and O=41, in fp32, and all three in bf16 at O=256, on one
    batch of the GAT main path.  ``segment_ms`` is the port's segment
    composite on the same batch (K4: the attention forward; K5 and K6:
    the whole backward of one head, which both together replace); no
    single PyTorch call computes these functions.  Each row prints its
    error beside its bar: K4 1e-5 relative (fp32), K5 and K6 1e-4.  No
    kernel adds with atomics, so K5's and K6's error measures only their
    order of summation (a lane's columns of each dot product, then one
    warp sum per row) against the plain version's matrix products."""
    import numpy as np

    from gist_tpu_torch.ops import gat_dedup as G
    from gist_tpu_torch.ops.segment import gat_attention_segment

    batch = sampler.make_batch(next(sampler.iter_node_ids()))
    g = batch.graph
    if g.dedup is None or g.dedup_t is None or g.dedup.pos is not None:
        raise RuntimeError("expected an unreordered dedup layout pair")
    gd = g.to(device)
    tf, tt, n = gd.dedup, gd.dedup_t, g.n_nodes
    nnz, nnz_t = _nnz(torch, tf), _nnz(torch, tt)
    emit({"phase": "gat_kernels", "batch_nodes": batch.n_real_nodes,
          "batch_edges": batch.n_real_edges, "n_pad": n,
          "tiles": tf.num_tiles, "jobs": int(tf.job_offsets[-1]),
          "w_blocks": list(tf.w_blocks.shape), "w_nonzero": nnz,
          "tiles_t": tt.num_tiles, "jobs_t": int(tt.job_offsets[-1]),
          "w_nonzero_t": nnz_t})
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(device)

    lay_f = (tf.job_offsets, tf.w_blocks, tf.u_senders)
    lay_t = (tt.job_offsets, tt.w_blocks, tt.u_senders)
    slope = 0.01
    rows = {}
    for heads, o, dtype in ((2, 256, torch.float32), (1, 41, torch.float32),
                            (2, 256, torch.bfloat16)):
        tag = f"H={heads} O={o} {str(dtype).split('.')[-1]}"
        fp32 = dtype == torch.float32
        item = 4 if fp32 else 2
        z = randn(n, heads, o).to(dtype)
        src, dst = randn(n, heads), randn(n, heads)
        dst_rows = G._to_rows(tf, dst)
        fwd_args = lay_f + (z, src, dst_rows, slope)
        out, m, l = G.gat_fwd(*fwd_args)
        rn = tf.num_tiles * tf.tile_rows
        rows[("K4", tag)] = _gat_row(
            torch, "K4", tag, (out, l), G.gat_fwd_reference(*fwd_args)[::2],
            1e-5 if fp32 else 1e-2, lambda: G.gat_fwd(*fwd_args),
            lambda: G.gat_fwd_reference(*fwd_args),
            lambda: gat_attention_segment(gd, z, src, dst, slope),
            _layout_bytes(tf) + z.numel() * item + (src.numel()
                                                    + dst_rows.numel()) * 4
            + rn * heads * (o * item + 8),
            nnz * heads * (2 * o + 6), dtype, kernel_name="gat_fwd_kernel")
        # K5 and K6 for head 0, on this forward's m and l
        zh, gh = z[:, 0].contiguous(), randn(n, o)
        sh, dh = src[:, 0].contiguous(), dst[:, 0].contiguous()
        c = (G._to_nodes(tf, out[:, 0], n).float() * gh).sum(1)
        m0, l0 = m[:, 0].contiguous(), l[:, 0].contiguous()
        b1_args = lay_f + (G._to_rows(tf, gh), zh, G._to_rows(tf, dh), sh,
                           m0, l0, G._to_rows(tf, c), slope)
        b2_args = lay_t + (G._to_rows(tt, zh), G._to_rows(tt, sh), gh, dh,
                           G._to_nodes(tf, m0, n).contiguous(),
                           G._to_nodes(tf, l0, n).contiguous(), c, slope)
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (zh.float(), sh, dh)]
        seg_out = gat_attention_segment(gd, *leaves, slope)

        def seg_bwd():
            return torch.autograd.grad(seg_out, leaves, gh,
                                       retain_graph=True)
        tol_b = 1e-4 if fp32 else 1e-2
        rt = tt.num_tiles * tt.tile_rows
        rows[("K5", tag)] = _gat_row(
            torch, "K5", tag, (G.gat_bwd_b1(*b1_args),),
            (G.gat_bwd_b1_reference(*b1_args),), tol_b,
            lambda: G.gat_bwd_b1(*b1_args),
            lambda: G.gat_bwd_b1_reference(*b1_args), seg_bwd,
            _layout_bytes(tf) + rn * o * 4 + n * o * item + rn * 4 * 5
            + n * 4, nnz * (2 * o + 10), dtype,
            kernel_name="gat_bwd_b1_kernel")
        rows[("K6", tag)] = _gat_row(
            torch, "K6", tag, G.gat_bwd_b2(*b2_args),
            G.gat_bwd_b2_reference(*b2_args), tol_b,
            lambda: G.gat_bwd_b2(*b2_args),
            lambda: G.gat_bwd_b2_reference(*b2_args), seg_bwd,
            _layout_bytes(tt) + 2 * rt * o * item + rt * 8 + n * o * 4
            + n * 16, nnz_t * (4 * o + 10), dtype,
            kernel_name="gat_bwd_b2_kernel")

    # K4 at H=2, O=256 in one launch (a warp per (row, head), a row's
    # heads neighbours in launch order) against one launch per head on
    # that head's contiguous slice: the yardstick for a warp that walks
    # both heads of its row (PERF.md, Findings)
    z2, src2 = randn(n, 2, 256), randn(n, 2)
    dst2 = randn(tf.num_tiles * tf.tile_rows, 2)
    both = lay_f + (z2, src2, dst2, slope)
    alone = [lay_f + tuple(t[:, h:h + 1].contiguous()
                           for t in (z2, src2, dst2)) + (slope,)
             for h in range(2)]
    emit({"phase": "gat_kernels", "kernel": "K4",
          "case": "H=2 O=256 float32, launches", "ms": {
              "one launch": _kernel_ms(torch, lambda: G.gat_fwd(*both)),
              "a launch per head": _kernel_ms(
                  torch, lambda: [G.gat_fwd(*a) for a in alone])}})
    return rows


def phase_gat_reference(torch, device, sampler):
    """One GAT sub-model of the main path (width 256, 2 heads, 2 layers)
    on three real batches, through K4-K6 and through the segment path:
    the first step's parameter gradients and the losses of three Adam
    steps must agree to 1e-4 relative (fp32; the order of summation is
    the only difference)."""
    from gist_tpu_torch.ist.ultrawide import build_local_burst_single
    from gist_tpu_torch.models import gat
    from gist_tpu_torch.models.common import masked_cross_entropy
    from gist_tpu_torch.ops import gat_dedup as G
    from gist_tpu_torch.ops import spmm
    from gist_tpu_torch.sampler import ClusterSampler
    from gist_tpu_torch.train.ist_cluster import (_batches_to_device,
                                                  _RoundCollector)

    sub_cfg = gat.GATConfig(sampler.features.shape[1], 512, 41, n_layers=2,
                            n_heads=2).sub_config(2)
    batches = _batches_to_device(
        _RoundCollector(sampler, 3, ids_only=True).collect(), device)
    if not all(b.graph.dedup is not None for b in batches):
        raise RuntimeError("reference batches lack a dedup layout")
    tables = sampler.tables(device)
    burst = build_local_burst_single(gat, sub_cfg, weight_decay=5e-4)
    init = gat.init(torch.Generator().manual_seed(0), sub_cfg)

    def fresh():
        return {"layers": [{k: v.to(device, copy=True) for k, v in l.items()}
                           for l in init["layers"]]}

    out = {}
    for backend in ("dedup", "segment"):
        spmm.set_default_backend(backend)
        G.reset_launches()
        sub = fresh()
        leaves = [t.requires_grad_(True)
                  for l in sub["layers"] for t in l.values()]
        graph, feats, labels, mask = ClusterSampler.resolve_batch(
            batches[0], tables)
        loss = masked_cross_entropy(
            gat.apply(sub, graph, feats, sub_cfg, train=True), labels, mask)
        grads = torch.autograd.grad(loss, leaves)
        _, losses = burst(fresh(), batches, 1e-2, None, tables)
        out[backend] = (grads, losses.cpu(),
                        (G.launches_fwd, G.launches_b1, G.launches_b2))
    spmm.set_default_backend("auto")
    (kg, kl, kn), (sg, sl, sn) = out["dedup"], out["segment"]
    g_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in
                zip(kg, sg))
    steps = 1 + len(batches)
    row = {"phase": "gat_reference", "steps": len(batches),
           "losses_kernels": kl.tolist(), "losses_segment": sl.tolist(),
           "grad_rel_err": g_err, "launches_k4_k5_k6": list(kn)}
    emit(row)
    if kn != (2 * steps, 3 * steps, 3 * steps) or sn != (0, 0, 0):
        raise RuntimeError(f"unexpected K4-K6 launches: {row}")
    if not (torch.allclose(kl, sl, rtol=1e-4, atol=1e-5) and g_err <= 1e-4):
        raise RuntimeError(f"K4-K6 training disagrees with the segment "
                           f"path: {row}")


def phase_gat_main_path(torch, ds):
    """The GAT main path, counting K4-K6 launches; then the same run once
    more under ``torch.profiler`` for its device time per step (the
    counts and host walls are the first run's)."""
    import dataclasses

    from gist_tpu_torch.models import gat
    from gist_tpu_torch.ops import gat_dedup as G
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.ist_cluster import train_ist_cluster

    cfg = gat.GATConfig(602, 512, 41, n_layers=2, n_heads=2)
    tc = TrainConfig(lr=1e-2, weight_decay=5e-4, n_epochs=8, num_subnet=2,
                     iter_per_site=4)

    def run():
        return train_ist_cluster(dataclasses.replace(ds), cfg, tc, psize=10,
                                 batch_size=4, normalize=True, model=gat,
                                 kind="gat", verbose=False, device="cuda")
    G.reset_launches()
    r = run()
    torch.cuda.synchronize()
    launches = (G.launches_fwd, G.launches_b1, G.launches_b2)
    _, prof = _profiled(torch, run)
    steps = len(r["losses"]) * tc.num_subnet * tc.iter_per_site
    emit({"phase": "gat_main_path", "rounds": len(r["losses"]),
          "steps": steps, "losses": r["losses"],
          "round_wall_s": r["round_wall_s"], "train_time_s": r["train_time"],
          "edges_per_sec": r["edges_per_sec"], "val_acc": r["val_accs"],
          "test_acc": r["test_accs"], "eval_times": r["eval_times"],
          "edges_per_batch": r["edges_per_batch"],
          "launches_k4_k5_k6": list(launches),
          "device_per_step": _device_split(
              prof, steps, {"K4": "gat_fwd_kernel", "K5": "gat_bwd_b1_kernel",
                            "K6": "gat_bwd_b2_kernel"}),
          "device_note": "a second run under torch.profiler: busy time "
                         "of the training steps and the full-graph evals, "
                         "per training step"})
    if len(r["losses"]) != 2 or steps != 16:
        raise RuntimeError(f"expected 2 rounds of 8 steps, got {steps}")
    if launches != (2 * steps, 3 * steps, 3 * steps):
        raise RuntimeError(f"K4/K5/K6 launched {launches} times, want "
                           f"2, 3 and 3 per step: some step skipped them")
    if not all(e >= 200_000 for e in r["edges_per_batch"]):
        raise RuntimeError("a batch fell under the layout's edge threshold")
    if not all(map(lambda v: v == v and abs(v) < float("inf"),
                   r["losses"] + r["val_accs"] + r["test_accs"])):
        raise RuntimeError("non-finite loss or accuracy")
    return launches


def _split_bound(torch, t, x, n_out_rows):
    """Least time for K2 over every chunk of ``t``: W, the per-job arrays
    and the remote ids of the real jobs, the offsets, every feature row
    read once and every output row written once, against the useful
    multiply-adds of W's nonzero counts."""
    f, item = x.shape[1], x.element_size()
    real = t.job_offsets[:, -1].tolist()
    nbytes = t.job_offsets.numel() * 4 + x.numel() * item \
        + n_out_rows * f * item
    nnz = 0
    for c, jobs in enumerate(real):
        rem_jobs = jobs - int(t.is_dir[c, :jobs].sum())
        nbytes += jobs * (t.tile_rows * t.cu + 12) + rem_jobs * t.cu * 4
        nnz += int(torch.count_nonzero(t.w_blocks[c, :jobs]))
    flops = 2 * nnz * f
    return _bound(nbytes, flops, x.dtype) + (nbytes, flops)


def _chunked_bytes_nnz(torch, t):
    """W, slots and offsets of the real jobs of every chunk, and W's
    nonzero counts."""
    nbytes = t.job_offsets.numel() * 4
    nnz = 0
    for c, jobs in enumerate(t.job_offsets[:, -1].tolist()):
        nbytes += jobs * (t.tile_rows * t.cu + t.cu * 4)
        nnz += int(torch.count_nonzero(t.w_blocks[c, :jobs]))
    return nbytes, nnz


def _split_layouts(g, cu):
    """The split layout pair of ``g`` at the amazon bench's settings
    (TN 64, threshold 128, 2^21 remote rows per chunk) and its build
    seconds."""
    from gist_tpu_torch.graph import _build_dedup_split_chunked
    m = g.n_edges
    kw = dict(tile_rows=64, cu=cu, threshold=128, chunk_rows=2 ** 21)
    t0 = time.time()
    fwd = _build_dedup_split_chunked(g.senders[:m].numpy(),
                                     g.receivers[:m].numpy(), g.n_nodes, **kw)
    bwd = _build_dedup_split_chunked(g.t_senders[:m].numpy(),
                                     g.t_receivers[:m].numpy(), g.n_nodes,
                                     **kw)
    return fwd, bwd, time.time() - t0


def phase_split_kernels(torch, device, g):
    """K2 against its plain version on the synth-amazon2m-small split
    layouts (CU 1024 and 512), forward and transpose, F=100 in fp32 and
    bf16 and F=47 (the split path's layer-1 width) in fp32: every chunk
    in one pass, with times beside the plain walk's and
    one ``torch.sparse.mm`` on the node-order adjacency.  Returns the
    rows and the CU=1024 layout pair (host tensors) for the split-path
    phase."""
    import numpy as np

    from gist_tpu_torch.ops import split_spmm as K2

    rng = np.random.default_rng(0)
    rows, keep = {}, None
    for cu in (1024, 512):
        fwd, bwd, build_s = _split_layouts(g, cu)
        if cu == 1024:
            keep = (fwd, bwd)
        for direction, lay in (("fwd", fwd), ("bwd", bwd)):
            t = lay.to(device)
            real = t.job_offsets[:, -1]
            direct = sum(int(t.is_dir[c, :int(j)].sum())
                         for c, j in enumerate(real.tolist()))
            emit({"phase": "split_kernels", "cu": cu, "direction": direction,
                  "build_s_pair": build_s, "n_chunks": t.n_chunks,
                  "tiles_per_chunk": t.tiles_per_chunk,
                  "jobs_pad": t.w_blocks.shape[1], "jobs": int(real.sum()),
                  "direct_jobs": direct, "remote_slots": t.u_senders.numel(),
                  "w_bytes": t.w_blocks.numel()})
            rows_c = t.tiles_per_chunk * t.tile_rows
            n_out = t.n_chunks * rows_c
            adj = _csr_adjacency(torch, g, torch.float32, device,
                                 transpose=direction == "bwd")
            for f, dtype in ((100, torch.float32), (100, torch.bfloat16),
                             (47, torch.float32)):
                x = torch.from_numpy(rng.standard_normal(
                    (g.n_nodes, f)).astype(np.float32))
                x = x.to(dtype).to(device)
                xp = x[t.perm.long()].contiguous()
                out = torch.empty((n_out, f), dtype=dtype, device=device)
                chunks = [(t.job_offsets[c], t.dir_blk[c], t.rem_blk[c],
                           t.is_dir[c], t.w_blocks[c], t.u_senders[c],
                           slice(c * rows_c, (c + 1) * rows_c))
                          for c in range(t.n_chunks)]

                def kernel():
                    for *lay_c, sl in chunks:
                        K2.split_spmm(*lay_c, xp, out=out[sl])
                    return out

                def plain():
                    return torch.cat([K2.split_spmm_reference(*lay_c, xp)
                                      for *lay_c, _ in chunks])
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                if not torch.isfinite(got.float()).all():
                    raise RuntimeError("K2 output is not finite")
                abs_err = float((got.float() - want.float()).abs().max())
                rel_err = abs_err / float(want.float().abs().max())
                tol = 1e-5 if dtype == torch.float32 else 1e-2
                bound_ms, bound_by, nbytes, flops = _split_bound(
                    torch, t, x, n_out)
                library_ms = library_call_ms = None
                if dtype == torch.float32:
                    library_ms = _kernel_ms(
                        torch, lambda: torch.sparse.mm(adj, x))
                    library_call_ms = _call_ms(
                        torch, lambda: torch.sparse.mm(adj, x), reps=10)
                ms = _kernel_ms(torch, kernel)
                row = {"phase": "split_kernels",
                       "case": f"{direction} CU={cu} F={f} "
                               f"{str(dtype).split('.')[-1]}",
                       "max_abs_err": abs_err, "rel_err": rel_err,
                       "tol": tol, "ms": ms,
                       "call_ms": _call_ms(torch, kernel, reps=10),
                       "plain_ms": _call_ms(torch, plain, reps=2,
                                            warmup=1),
                       "library_ms": library_ms,
                       "library_call_ms": library_call_ms,
                       "library": "torch.sparse.mm on a CSR adjacency "
                                  "(fp32 only)",
                       "ms_over_library": library_ms and ms / library_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "bound_bytes": nbytes, "useful_flops": flops,
                       **_grid(t.job_offsets, f, t.tile_rows)}
                emit(row)
                if not rel_err <= tol:
                    raise RuntimeError(f"K2 disagrees with its plain "
                                       f"version: {row}")
                rows[row["case"]] = row
            del t, adj
        torch.cuda.empty_cache()
    return rows, keep


def phase_split_path(torch, device, ds, g, split_pair):
    """One GCN h256 (1 hidden layer, dropout 0) training step through
    ``gcn.apply`` on the split layouts (K2) and on the chunked layouts
    of the same graph (K1 per chunk): losses to 1e-4 relative, first-step
    gradients to 1e-3 norm-wise per leaf (two summation orders can flip
    a ReLU input; see PERF.md).  Layer 0 aggregates x, which takes no
    gradient: K2 runs twice forward per chunk and once backward."""
    from gist_tpu_torch.models import gcn
    from gist_tpu_torch.models.common import masked_cross_entropy
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.ops import split_spmm as K2

    t0 = time.time()
    gk = g.with_tiles(mode="dedup-chunked", chunk_rows=2 ** 21)
    chunked_build_s = time.time() - t0
    graphs = {"split": g.replace(dedup_c=split_pair[0],
                                 dedup_c_t=split_pair[1]).to(device),
              "chunked": gk.to(device)}
    cfg = gcn.GCNConfig(ds.in_feats, 256, ds.n_classes, n_layers=1,
                        dropout=0.0)
    init = gcn.init(torch.Generator(device=device).manual_seed(0), cfg)
    x = torch.from_numpy(ds.features).to(device)
    labels = torch.from_numpy(ds.labels).to(device)
    mask = torch.from_numpy(ds.train_mask).to(device)
    out = {}
    for name, gr in graphs.items():
        params = {"layers": [{k: v.clone().requires_grad_(True)
                              for k, v in l.items()}
                             for l in init["layers"]]}
        leaves = [t for l in params["layers"] for t in l.values()]
        K.launches = K2.launches = 0
        loss = masked_cross_entropy(
            gcn.apply(params, gr, x, cfg, train=True, backend="dedup"),
            labels, mask)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        out[name] = (float(loss.detach()), grads, K.launches, K2.launches)
    (ls, gs, k1s, k2s), (lk, gk_, k1k, k2k) = out["split"], out["chunked"]
    norm_err = [float((a - b).norm() / b.norm()) for a, b in zip(gs, gk_)]
    sp, ch = graphs["split"], graphs["chunked"]
    want_k2 = 2 * sp.dedup_c.n_chunks + sp.dedup_c_t.n_chunks
    want_k1 = 2 * ch.dedup_c.n_chunks + ch.dedup_c_t.n_chunks
    row = {"phase": "split_path", "loss_split": ls, "loss_chunked": lk,
           "grad_norm_rel_err_per_leaf": norm_err,
           "k2_launches": k2s, "k1_launches_split_run": k1s,
           "k1_launches_chunked_run": k1k, "k2_launches_chunked_run": k2k,
           "chunked_n_chunks": [ch.dedup_c.n_chunks, ch.dedup_c_t.n_chunks],
           "chunked_build_s_pair": chunked_build_s}
    emit(row)
    if (k2s, k1s, k1k, k2k) != (want_k2, 0, want_k1, 0):
        raise RuntimeError(f"unexpected K1/K2 launches (want K2 {want_k2} "
                           f"on the split run, K1 {want_k1} on the chunked "
                           f"run): {row}")
    if not (abs(ls - lk) <= 1e-4 * abs(lk) and max(norm_err) <= 1e-3):
        raise RuntimeError(f"the split path disagrees with the chunked "
                           f"path: {row}")
    return k2s


def phase_full_path(torch, device, ds):
    """The full-scale main path: ``train_full_graph`` with GCN h256, one
    hidden layer, dropout 0.5, lr 1e-2, weight decay 5e-4 and the LR
    schedule, 6 epochs on synth-reddit with self loops.  The graph is
    above ``HUGE_EDGES``, so ``prepare_graph`` builds the chunked pair
    and K1 runs once per chunk: per epoch 4 x C_f launches (layers 0 and
    1, train and eval) and 2 x C_t (their backward).  Returns the
    launches, the graph on the card and the rows of the chunked-K1
    check."""
    from gist_tpu_torch.models.gcn import GCNConfig
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.full_graph import prepare_graph, train_full_graph

    t0 = time.time()
    graph = prepare_graph(ds)
    layout_build_s = time.time() - t0
    if graph.dedup_c is None or graph.dedup_c_t is None:
        raise RuntimeError("synth-reddit did not get the chunked layouts")
    cf, ct = graph.dedup_c.n_chunks, graph.dedup_c_t.n_chunks
    emit({"phase": "full_path", "nodes": ds.n_nodes, "edges": ds.n_edges,
          "layout_build_s": layout_build_s, "n_chunks": [cf, ct],
          "tiles_per_chunk": graph.dedup_c.tiles_per_chunk,
          "jobs_pad": graph.dedup_c.w_blocks.shape[1],
          "jobs": int(graph.dedup_c.job_offsets[:, -1].sum()),
          "w_bytes_pair": graph.dedup_c.w_blocks.numel()
          + graph.dedup_c_t.w_blocks.numel()})
    graph = graph.to(device)
    cfg = GCNConfig(ds.in_feats, 256, ds.n_classes, n_layers=1, dropout=0.5)
    tc = TrainConfig(lr=1e-2, weight_decay=5e-4, n_epochs=6,
                     lr_schedule=True)
    torch.cuda.reset_peak_memory_stats()
    K.launches = 0
    r = train_full_graph(ds, cfg, tc, graph=graph, device="cuda",
                         verbose=False)
    torch.cuda.synchronize()
    launches = K.launches
    emit({"phase": "full_path", "epochs": tc.n_epochs,
          "layout_build_s": layout_build_s,
          "mean_epoch_s": r["mean_epoch_s"], "kteps": r["kteps"],
          "losses": r["losses"], "val_accs": r["val_accs"],
          "test_accs": r["test_accs"],
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "k1_launches": launches})
    want = tc.n_epochs * (4 * cf + 2 * ct)
    if launches != want:
        raise RuntimeError(f"K1 launched {launches} times, want {want} "
                           f"(4 C_f + 2 C_t per epoch)")
    if not all(v == v and abs(v) < float("inf") for v in r["losses"]):
        raise RuntimeError("non-finite loss")
    return launches, graph, _check_chunked_k1(torch, device, graph)


def _timed(torch, fn):
    """(fn's result, its milliseconds on the card) of one call."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    res = fn()
    b.record()
    b.synchronize()
    return res, a.elapsed_time(b)


def _chunked_plain(torch, t, x, n_nodes):
    """The chunked K1 runner's plain version: the same permutation, each
    chunk's plain walk, the same row map."""
    from gist_tpu_torch.ops import dedup_spmm as K
    xp = x.index_select(0, t.perm) if t.perm is not None else x
    out = torch.cat([K.dedup_spmm_reference(t.job_offsets[c], t.w_blocks[c],
                                            t.u_senders[c], xp)
                     for c in range(t.n_chunks)])
    return out.index_select(0, t.pos) if t.pos is not None else out[:n_nodes]


def _check_chunked_k1(torch, device, graph):
    """K1 once per chunk at the full-scale path's own shapes: forward on
    ``dedup_c`` and transpose on ``dedup_c_t``, at F=256 (layer 0) and
    F=41 (layer 1), fp32, against the plain version (1e-5 relative to
    max|plain|) and against the segment aggregation of the same graph,
    which knows nothing of the layout's perm and pos (1e-5 relative to
    max|segment|).  The bound counts the features once and the
    kernel-order output once; ``library_ms`` is one ``torch.sparse.mm``
    on the node-order CSR adjacency, the whole pass's yardstick (the
    runner's permutation of x and of the rows included)."""
    import numpy as np

    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.ops.spmm import spmm_segment_chunked

    rng = np.random.default_rng(0)
    n = graph.n_nodes
    rows = {}
    for direction, g in (("fwd", graph), ("bwd", graph.transpose())):
        t = g.dedup_c
        lay_bytes, nnz = _chunked_bytes_nnz(torch, t)
        out_rows = t.n_chunks * t.tiles_per_chunk * t.tile_rows
        adj = _csr_adjacency(torch, graph, torch.float32, device,
                             transpose=direction == "bwd")
        for f in (256, 41):
            x = torch.from_numpy(rng.standard_normal(
                (n, f)).astype(np.float32)).to(device)
            got = K.run_dedup_chunked(t, x, n)
            want, plain_ms = _timed(torch, lambda: _chunked_plain(
                torch, t, x, n))
            seg, segment_ms = _timed(torch, lambda: spmm_segment_chunked(
                g, x))
            if not torch.isfinite(got).all():
                raise RuntimeError("chunked K1 output is not finite")
            abs_err = float((got - want).abs().max())
            rel_err = abs_err / float(want.abs().max())
            seg_err = float((got - seg).abs().max() / seg.abs().max())
            lib_err = float((got - torch.sparse.mm(adj, x)).abs().max()
                            / seg.abs().max())
            bound_ms, bound_by = _bound(
                lay_bytes + (n + out_rows) * f * 4, 2 * nnz * f,
                torch.float32)
            ms = _kernel_ms(torch, lambda: K.run_dedup_chunked(t, x, n),
                            windows=3)
            call_ms = _call_ms(torch, lambda: K.run_dedup_chunked(t, x, n),
                               reps=5)
            library_ms = _kernel_ms(torch, lambda: torch.sparse.mm(adj, x),
                                    windows=3)
            library_call_ms = _call_ms(
                torch, lambda: torch.sparse.mm(adj, x), reps=5)
            row = {"phase": "full_path",
                   "case": f"run_dedup_chunked {direction} F={f} float32",
                   "n_chunks": t.n_chunks, "max_abs_err": abs_err,
                   "rel_err": rel_err, "segment_rel_err": seg_err,
                   "library_rel_err": lib_err, "tol": 1e-5, "ms": ms,
                   "call_ms": call_ms, "plain_ms": plain_ms,
                   "segment_ms": segment_ms, "library_ms": library_ms,
                   "library_call_ms": library_call_ms,
                   "library": "torch.sparse.mm on a CSR adjacency",
                   "ms_over_library": ms / library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "w_nonzero": nnz,
                   **_grid(t.job_offsets, f, t.tile_rows)}
            emit(row)
            if not (rel_err <= 1e-5 and seg_err <= 1e-5):
                raise RuntimeError(f"chunked K1 disagrees with its plain "
                                   f"version or the segment path: {row}")
            rows[row["case"]] = row
            del x, got, want, seg
        del adj
    return rows


def phase_gat_chunked(torch, device, ds, graph):
    """A full-graph GAT forward (h512, 2 heads, 2 layers, parameters from
    a seed) on the synth-reddit graph's chunked layout through K4 once
    per chunk and layer, against the segment path: 1e-4 relative to
    max|segment|."""
    from gist_tpu_torch.models import gat
    from gist_tpu_torch.ops import gat_dedup as G

    cfg = gat.GATConfig(ds.in_feats, 512, ds.n_classes, n_layers=2,
                        n_heads=2)
    params = gat.init(torch.Generator(device=device).manual_seed(0), cfg)
    x = torch.from_numpy(ds.features).to(device)
    with torch.no_grad():
        G.reset_launches()
        got = gat.apply(params, graph, x, cfg, backend="dedup")
        torch.cuda.synchronize()
        launches = G.launches_fwd
        want = gat.apply(params, graph, x, cfg, backend="segment")
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        # layer 0's attention alone: K4 per chunk over both heads
        layer = params["layers"][0]
        z = torch.einsum("nf,hfo->nho", x, layer["w"]).contiguous()
        src = torch.einsum("nho,ho->nh", z, layer["attn"][:, :512])
        dst = torch.einsum("nho,ho->nh", z, layer["attn"][:, 512:])
        t = graph.dedup_c
        lay_bytes, nnz = _chunked_bytes_nnz(torch, t)
        rows = t.n_chunks * t.tiles_per_chunk * t.tile_rows
        heads, o = z.shape[1], z.shape[2]
        l0_bound = _bound(lay_bytes + z.numel() * 4 + src.numel() * 8
                          + rows * heads * (o * 4 + 8),
                          nnz * heads * (2 * o + 6), torch.float32)
        row = {"phase": "gat_chunked", "k4_launches": launches,
               "max_abs_err": err, "rel_err": rel, "tol": 1e-4,
               "finite": bool(torch.isfinite(got).all()),
               "layer0_attention_ms": _call_ms(
                   torch, lambda: G.gat_attention_dedup_chunked(
                       graph, z, src, dst), reps=3, warmup=1),
               "layer0_bound_ms": l0_bound[0],
               "layer0_bound_by": l0_bound[1],
               "ms": _call_ms(torch, lambda: gat.apply(
                   params, graph, x, cfg, backend="dedup"), reps=3,
                   warmup=1),
               "segment_ms": _call_ms(torch, lambda: gat.apply(
                   params, graph, x, cfg, backend="segment"), reps=3,
                   warmup=1)}
    emit(row)
    if launches != 2 * graph.dedup_c.n_chunks:
        raise RuntimeError(f"K4 launched {launches} times, want "
                           f"{2 * graph.dedup_c.n_chunks} (2 x C_f)")
    if not (row["finite"] and rel <= 1e-4):
        raise RuntimeError(f"chunked K4 disagrees with the segment path: "
                           f"{row}")
    return launches


def _v1_layout_bytes(t):
    """Tile offsets and the senders and receivers of the slots up to
    ``tile_offsets[-1]`` (padding slots past it are never read)."""
    return t.tile_offsets.numel() * 4 + int(t.tile_offsets[-1]) * 8


def _v1_row(torch, phase, name, case, got, want, tol, kernel, plain,
            nbytes, flops, dtype, timers, plain_reps, gathered,
            kernel_name=None):
    """Time a v1 kernel beside its plain version and the ``timers``
    (name -> function or None); raise unless every output is finite and
    within ``tol`` of the plain result relative to its max.  ``gathered``
    is the bytes of the rows the walk reads per slot (real slots x row
    bytes), printed with the rate at ``ms`` beside the bound, which
    counts each byte once.  With ``kernel_name`` (a redesigned kernel)
    also its profiler time and one-call time of the ``timers``, and
    raise unless two launches give the same bits."""
    torch.cuda.synchronize()
    abs_err = rel_err = 0.0
    for a, b in zip(got, want):
        if not torch.isfinite(a.float()).all():
            raise RuntimeError(f"{name} {case}: output is not finite")
        err = float((a.float() - b.float()).abs().max())
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / max(float(b.float().abs().max()),
                                          1e-30))
    bound_ms, bound_by = _bound(nbytes, flops, dtype)
    row = {"phase": phase, "kernel": name, "case": case,
           "max_abs_err": abs_err, "rel_err": rel_err, "tol": tol,
           "ms": _kernel_ms(torch, kernel),
           "call_ms": _call_ms(torch, kernel, reps=20),
           "plain_ms": _call_ms(torch, plain, reps=plain_reps, warmup=1),
           **{k: None if fn is None else _kernel_ms(torch, fn)
              for k, fn in timers.items()},
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_bytes": nbytes, "useful_flops": flops}
    row.update({"gathered_bytes": gathered,
                "gathered_tb_s": gathered / row["ms"] / 1e9})
    if kernel_name:
        row.update({k.replace("_ms", "_call_ms"):
                    None if fn is None else _call_ms(torch, fn, reps=10)
                    for k, fn in timers.items()})
        row.update(_redesign_checks(torch, kernel, kernel_name))
    emit(row)
    if not rel_err <= tol:
        raise RuntimeError(f"{name} disagrees with its plain version: {row}")
    if kernel_name and not row["bitwise_repeat"]:
        raise RuntimeError(f"{name}: two launches differ: {row}")
    return row


def _library_spmm(torch, g, dtype, device, transpose, x):
    """``torch.sparse.mm`` on the node-order adjacency, or None where it
    has no kernel for ``dtype``."""
    adj = _csr_adjacency(torch, g, dtype, device, transpose=transpose)
    try:
        torch.sparse.mm(adj, x)
    except RuntimeError:
        return None
    return lambda: torch.sparse.mm(adj, x)


def _alpha_spmm(torch, GT, g, device, src, dst, m, l, slope, gg, tol,
                want):
    """K9's dz part as one library call: ``torch.sparse.mm`` of the
    transpose pattern (rows the original senders, columns the original
    receivers, node order) with each edge's alpha in its values, times
    G.  The matrix is built once and not timed; raise unless its product
    is within ``tol`` of ``want`` (K9's dz) relative to its max."""
    e, n = g.n_edges, g.n_nodes
    s = g.senders[:e].long().to(device)
    r = g.receivers[:e].long().to(device)
    alpha = GT._alpha(src[s] + dst[r], m[r], l[r], slope)[0]
    adj = torch.sparse_coo_tensor(torch.stack([s, r]), alpha,
                                  (n, n)).coalesce().to_sparse_csr()
    got = torch.sparse.mm(adj, gg)
    err = float((got - want[:n].float()).abs().max()
                / want[:n].float().abs().max().clamp(min=1e-30))
    if not err <= tol:
        raise RuntimeError(f"the dz part by torch.sparse.mm is {err} off "
                           f"K9's dz")
    return lambda: torch.sparse.mm(adj, gg)


def _v1_kernel_rows(torch, device, g, phase, k3_cases, gat_cases,
                    plain_reps):
    """K3 (forward on ``tiled``, transpose on ``tiled_t``) and K7, K8, K9
    on the host graph ``g``'s v1 pair, each against its plain walk.  The
    bounds count each input byte once and each output byte once, against
    the useful 2·E·F (K3) or 2·E·D (K7-K9) operations.  Returns the rows
    by (kernel, case)."""
    import numpy as np

    from gist_tpu_torch.ops import gat_tiled as GT
    from gist_tpu_torch.ops import tiled_spmm as K3
    from gist_tpu_torch.ops.segment import gat_attention_segment

    gd = g.to(device)
    n, e = g.n_nodes, g.n_edges
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(device)
    rows = {}
    for f, dtype in k3_cases:
        x = randn(n, f).to(dtype)
        item = x.element_size()
        tag = str(dtype).split(".")[-1]
        for direction, t in (("fwd", gd.tiled), ("bwd", gd.tiled_t)):
            case = f"{direction} F={f} {tag}"
            out_rows = t.num_tiles * t.tile_rows
            rows[("K3", case)] = _v1_row(
                torch, phase, "K3", case, (K3.tiled_spmm(t, x),),
                (K3.tiled_spmm_reference(t, x),),
                1e-5 if dtype == torch.float32 else 1e-2,
                lambda: K3.tiled_spmm(t, x),
                lambda: K3.tiled_spmm_reference(t, x),
                _v1_layout_bytes(t) + (n + out_rows) * f * item,
                2 * e * f, dtype,
                {"library_ms": _library_spmm(torch, g, dtype, device,
                                             direction == "bwd", x)},
                plain_reps, e * f * item, kernel_name="tiled_spmm_kernel")
    slope = 0.01
    tf, tt = gd.tiled, gd.tiled_t
    rows_f, rows_t = tf.num_tiles * tf.tile_rows, tt.num_tiles * tt.tile_rows
    slots_f = int(tf.tile_offsets[-1])
    for d, dtype in gat_cases:
        tag = f"D={d} {str(dtype).split('.')[-1]}"
        fp32 = dtype == torch.float32
        tol = 1e-5 if fp32 else 1e-2
        item = 4 if fp32 else 2
        z, src, dst, gg = randn(n, d).to(dtype), randn(n), randn(n), \
            randn(n, d)
        out, m, l = GT.gat_tiled_fwd(tf, z, src, dst, slope)
        want = GT.gat_tiled_fwd_reference(tf, z, src, dst, slope)
        torch.cuda.synchronize()
        has = want[2] > 0
        if not (torch.all(m[~has] == -1e30) and torch.all(l[~has] == 0)
                and torch.all(out[~has] == 0)):
            raise RuntimeError(f"K7 {tag}: an empty row is not (0, -1e30, 0)")
        # m against the plain max on the rows with edges (empty rows hold
        # the -1e30 sentinel, checked above)
        rows[("K7", tag)] = _v1_row(
            torch, phase, "K7", tag,
            (out, l, torch.where(has, m, 0.0)),
            (want[0], want[2], torch.where(has, want[1], 0.0)), tol,
            lambda: GT.gat_tiled_fwd(tf, z, src, dst, slope),
            lambda: GT.gat_tiled_fwd_reference(tf, z, src, dst, slope),
            _v1_layout_bytes(tf) + n * d * item + 2 * n * 4
            + rows_f * (d * item + 8), 2 * e * d, dtype,
            {"segment_ms": lambda: gat_attention_segment(gd, z, src, dst,
                                                         slope)},
            plain_reps, e * d * item, kernel_name="tiled_gat_fwd_kernel")
        b1 = (tf, z, src, dst, m, l, gg, slope)
        ds, _ = GT.gat_tiled_bwd_b1(*b1)
        b2 = (tt, ds, gg, src, dst, m, l, slope, dtype)
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (z.float(), src, dst)]
        seg_out = gat_attention_segment(gd, *leaves, slope)

        def seg_bwd():
            return torch.autograd.grad(seg_out, leaves, gg,
                                       retain_graph=True)
        rows[("K8", tag)] = _v1_row(
            torch, phase, "K8", tag, GT.gat_tiled_bwd_b1(*b1),
            GT.gat_tiled_bwd_b1_reference(*b1), tol,
            lambda: GT.gat_tiled_bwd_b1(*b1),
            lambda: GT.gat_tiled_bwd_b1_reference(*b1),
            _v1_layout_bytes(tf) + n * d * (item + 4) + 2 * n * 4
            + rows_f * 12 + slots_f * 4, 2 * e * d, dtype,
            {"segment_ms": seg_bwd}, plain_reps, e * d * item,
            kernel_name="tiled_gat_b1_kernel")
        got = GT.gat_tiled_bwd_b2(*b2)
        dz_library = _alpha_spmm(
            torch, GT, g, device, src, dst, m, l, slope, gg, tol, got[0])
        rows[("K9", tag)] = _v1_row(
            torch, phase, "K9", tag, got,
            GT.gat_tiled_bwd_b2_reference(*b2), tol,
            lambda: GT.gat_tiled_bwd_b2(*b2),
            lambda: GT.gat_tiled_bwd_b2_reference(*b2),
            _v1_layout_bytes(tt) + int(tt.tile_offsets[-1]) * 4
            + slots_f * 4 + n * d * 4 + 2 * n * 4 + rows_f * 8
            + rows_t * (d * item + 4), 2 * e * d, dtype,
            {"segment_ms": seg_bwd, "dz_library_ms": dz_library},
            plain_reps, e * d * 4, kernel_name="tiled_gat_b2_kernel")
        del got, dz_library
        del z, gg, leaves, seg_out
    torch.cuda.empty_cache()
    return rows


def _unique_share(torch, t, n_nodes):
    """Unique (destination tile, sender) pairs over the real slots of a
    v1 layout, as a share of them: the most that staging each tile's
    sender rows once could cut the per-slot row gathers to."""
    used = int(t.tile_offsets[-1])
    rcv = t.receivers[:used].long()
    real = rcv < t.num_tiles * t.tile_rows
    keys = (rcv[real] // t.tile_rows) * n_nodes + t.senders[:used].long()[real]
    return torch.unique(keys).numel() / max(int(real.sum()), 1)


def _v1_shape(torch, phase, g):
    t, tt = g.tiled, g.tiled_t
    emit({"phase": phase, "nodes": g.n_nodes, "edges": g.n_edges,
          "tiles": t.num_tiles, "slots": int(t.tile_offsets[-1]),
          "slots_padded": t.senders.shape[0], "max_chunks": t.max_chunks,
          "tiles_t": tt.num_tiles, "slots_t": int(tt.tile_offsets[-1]),
          "max_chunks_t": tt.max_chunks,
          "unique_tile_sender_share": _unique_share(torch, t, g.n_nodes),
          "unique_tile_sender_share_t": _unique_share(torch, tt, g.n_nodes)})


def phase_k3_plans(torch, device, g):
    """K3's launch plans side by side on the full synth-reddit-small v1
    graph, forward and transpose, fp32: at F=41 and F=47 (odd rows,
    scalar loads) and at F=256 (float4 loads) the edges and the rows
    mode with groups of 8 and 16 lanes.  Each is held against the chosen plan's output (1e-5
    relative to its max; the chosen plan is held against the plain walk
    in the v1 phases) and timed like the kernels.  Returns the rows."""
    import numpy as np

    from gist_tpu_torch.ops import tiled_spmm as K3

    gd = g.to(device)
    deg = torch.bincount(gd.receivers[:g.n_edges].long(),
                         minlength=g.n_nodes)
    emit({"phase": "k3_plans", "in_degree_mean": float(deg.float().mean()),
          "in_degree_max": int(deg.max()),
          "in_degree_p99": float(deg.float().quantile(0.99))})
    rng = np.random.default_rng(0)
    out = []
    for f, vec in ((41, 1), (47, 1), (256, 4)):
        # each group's fewest vectors a lane that cover F, at most
        # MAX_ACC accumulators
        plans = [K3.Plan(rows, group,
                         min(-(-f // (group * vec)), K3.MAX_ACC // vec), vec)
                 for rows in (False, True) for group in K3.GROUPS]
        x = torch.from_numpy(rng.standard_normal(
            (g.n_nodes, f)).astype(np.float32)).to(device)
        for direction, t in (("fwd", gd.tiled), ("bwd", gd.tiled_t)):
            want = K3.tiled_spmm(t, x)
            chosen = K3.launch_plan(f, K3.vec_width(f, 4, x.data_ptr(),
                                                    want.data_ptr()))
            for plan in dict.fromkeys(plans + [chosen]):
                got = K3.run_plan(t, x, plan)
                err = float((got - want).abs().max() / want.abs().max())
                row = {"phase": "k3_plans",
                       "case": f"{direction} F={f} float32",
                       "plan": plan._asdict(), "chosen": plan == chosen,
                       "ms": _kernel_ms(torch,
                                        lambda: K3.run_plan(t, x, plan)),
                       "rel_err_vs_chosen": err}
                emit(row)
                if not err <= 1e-5:
                    raise RuntimeError(f"K3 plans disagree: {row}")
                out.append(row)
        del x
    return out


def phase_v1_gat_plans(torch, device, g):
    """K7's, K8's and K9's launch plans side by side on the full
    synth-reddit-small v1 graph, fp32, at D=41 (odd rows, scalar loads)
    and D=512 (float4 loads): every plan of each plan space
    (``gat_tiled.plan_space``), each held against the chosen plan's
    output (1e-5 relative to its max, m exactly; the chosen plan is held
    against the plain walk in the v1 phases) and timed like the kernels,
    every plan once a round over three rounds (``ms``: the median).
    Then, for K9, the best plan whose lanes hold at most 8 accumulators
    (K7's cap: four block columns of 128 at D=512) beside the best with
    at most ``B2_MAX``.  Returns the rows."""
    import numpy as np

    from gist_tpu_torch.ops import gat_tiled as GT

    gd = g.to(device)
    t, tt = gd.tiled, gd.tiled_t
    n = g.n_nodes
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(device)
    src, dst = randn(n), randn(n)
    rows = []
    for d in (41, 512):
        z, gg = randn(n, d), randn(n, d)
        fwd = GT.gat_tiled_fwd(t, z, src, dst, 0.01)
        m, l = fwd[1], fwd[2]
        b1 = GT.gat_tiled_bwd_b1(t, z, src, dst, m, l, gg, 0.01)
        b2 = GT.gat_tiled_bwd_b2(tt, b1[0], gg, src, dst, m, l, 0.01)
        vec = GT.vec_width(d, 4, z.data_ptr(), fwd[0].data_ptr())
        runs = []
        for plan in GT.plan_space(d, vec, GT.FWD_MAX):
            runs.append(("K7", {"plan": plan._asdict(),
                                "chosen": plan == GT.fwd_plan(d, vec)},
                         lambda p=plan: GT.run_fwd_plan(
                             t, z, src, dst, 0.01, p), fwd))
        for plan in GT.plan_space(d, vec, GT.B1_MAX):
            runs.append(("K8", {"plan": plan._asdict(),
                                "chosen": plan == GT.b1_plan(d, vec)},
                         lambda p=plan: GT.run_b1_plan(
                             t, z, src, dst, m, l, gg, 0.01, p), b1))
        for plan in GT.plan_space(d, vec, GT.B2_MAX):
            runs.append(("K9", {"plan": plan._asdict(),
                                "chosen": plan == GT.b2_plan(d, vec)},
                         lambda p=plan: GT.run_b2_plan(
                             tt, b1[0], gg, src, dst, m, l, 0.01, p), b2))
        errs = []
        for kernel, variant, fn, want in runs:
            got = fn()
            torch.cuda.synchronize()
            errs.append(max(float((a - b).abs().max() / b.abs().max())
                            for i, (a, b) in enumerate(zip(got, want))
                            if not (kernel == "K7" and i == 1)))
            if not errs[-1] <= 1e-5 or (kernel == "K7" and not torch.equal(
                    got[1], want[1])):
                raise RuntimeError(f"{kernel} {variant} at D={d} disagrees "
                                   f"with the chosen plan: {errs[-1]}")
        # every plan once a round, in turns, so drift falls on all alike
        times = [[_kernel_ms(torch, fn) for _, _, fn, _ in runs]
                 for _ in range(3)]
        caps = {}
        for i, (kernel, variant, _, _) in enumerate(runs):
            row = {"phase": "v1_gat_plans", "kernel": kernel,
                   "case": f"D={d} float32", **variant,
                   "ms": statistics.median(t[i] for t in times),
                   "ms_rounds": [t[i] for t in times],
                   "rel_err_vs_chosen": errs[i]}
            emit(row)
            rows.append(row)
            plan = variant["plan"]
            values = plan["per_lane"] * plan["vec"]
            if kernel == "K9":
                for cap in (8, GT.B2_MAX):
                    if values <= cap and (cap not in caps or row["ms"]
                                          < caps[cap]["ms"]):
                        caps[cap] = {"ms": row["ms"], "plan": plan}
        emit({"phase": "v1_gat_plans", "kernel": "K9",
              "case": f"D={d} float32", "best_by_cap": {
                  str(cap): best for cap, best in sorted(caps.items())}})
        del z, gg, fwd, b1, b2
    return rows


def phase_v1_kernels(torch, device, ds):
    """K3 at F=602 and 256 fp32 and 256 bf16, K7-K9 at D=512 and 41 fp32
    and 512 bf16, on one batch of the gather-mode sampler (bucketed by
    ``pad_tiled_csr``).  ``segment_ms`` is the port's segment composite on
    the same batch (K7: the attention forward; K8 and K9: the whole
    backward of one head, which both together replace)."""
    from gist_tpu_torch.sampler import ClusterSampler
    sampler = ClusterSampler(ds, 10, 4, seed=0, tiles=True,
                             tile_mode="gather")
    g = sampler.make_batch(next(sampler.iter_node_ids())).graph
    if g.tiled is None or g.tiled_t is None or g.dedup is not None:
        raise RuntimeError("expected a v1 layout pair on the batch")
    _v1_shape(torch, "v1_kernels", g)
    return _v1_kernel_rows(
        torch, device, g, "v1_kernels",
        ((602, torch.float32), (256, torch.float32), (256, torch.bfloat16)),
        ((512, torch.float32), (41, torch.float32), (512, torch.bfloat16)),
        plain_reps=3)


def phase_v1_reference(torch, device, ds, graph):
    """Two Adam steps (lr 1e-2, weight decay 5e-4) from one seeded
    initialisation on the full synth-reddit-small v1 graph, through the
    kernels and through the segment path (GAT h512, 2 heads, 2 layers,
    through K7-K9; GCN h256, 1 hidden layer, dropout 0, through K3):
    losses to 1e-4 relative.  GAT's first-step gradients are held to
    1e-4 max-relative per leaf, except the last layer's ``attn``: a
    last-bit change (the segment path sums with atomics) puts a score
    on the leaky ReLU's kink now and then, which moves that leaf by
    ~1.25e-4 norm-wise run to run in the fp32 segment path itself (see
    PERF.md), so it is held norm-wise at 5e-4.  GCN's gradients are held
    to 1e-3 norm-wise per leaf, as its ReLU flips the same way.  Both
    fp32 paths' errors against the segment path run in float64 are
    printed beside."""
    from gist_tpu_torch.models import gat, gcn
    from gist_tpu_torch.models.common import masked_cross_entropy
    from gist_tpu_torch.ops import gat_tiled as GT
    from gist_tpu_torch.ops import tiled_spmm as K3
    from gist_tpu_torch.train.common import make_optimizer

    x = torch.from_numpy(ds.features).to(device)
    labels = torch.from_numpy(ds.labels).to(device)
    mask = torch.from_numpy(ds.train_mask).to(device)

    def run(model, cfg, backend):
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            cfg)
        leaves = [t.requires_grad_(True)
                  for l in params["layers"] for t in l.values()]
        opt = make_optimizer(leaves, 1e-2, 5e-4)
        losses, grads = [], None
        for _ in range(2):
            opt.zero_grad(set_to_none=True)
            loss = masked_cross_entropy(
                model.apply(params, graph, x, cfg, train=True,
                            backend=backend), labels, mask)
            loss.backward()
            if grads is None:
                grads = [t.grad.clone() for t in leaves]
            opt.step()
            losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        return losses, grads

    def exact_grads(model, cfg):
        """First-step gradients through the segment path in float64."""
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            cfg)
        leaves = [t.double().requires_grad_(True)
                  for l in params["layers"] for t in l.values()]
        it = iter(leaves)
        p64 = {"layers": [{k: next(it) for k in l}
                          for l in params["layers"]]}
        loss = masked_cross_entropy(
            model.apply(p64, graph, x.double(), cfg, train=True,
                        backend="segment"), labels, mask)
        return torch.autograd.grad(loss, leaves)

    def max_rel(a_list, b_list):
        return [float((a.double() - b).abs().max() / b.abs().max())
                for a, b in zip(a_list, b_list)]

    checks = (
        ("gat", gat, gat.GATConfig(ds.in_feats, 512, ds.n_classes,
                                   n_layers=2, n_heads=2), (6, 6, 6)),
        ("gcn", gcn, gcn.GCNConfig(ds.in_feats, 256, ds.n_classes,
                                   n_layers=1, dropout=0.0), (8,)))
    for name, model, cfg, want_launches in checks:
        out = {}
        for backend in ("dedup", "segment"):
            GT.reset_launches()
            K3.launches = 0
            losses, grads = run(model, cfg, backend)
            counts = ((GT.launches_fwd, GT.launches_b1, GT.launches_b2)
                      if name == "gat" else (K3.launches,))
            out[backend] = (losses, grads, counts)
        (kl, kg, kn), (sl, sg, sn) = out["dedup"], out["segment"]
        exact = exact_grads(model, cfg)
        max_err = max_rel(kg, sg)
        norm_err = [float((a - b).norm() / b.norm()) for a, b in zip(kg, sg)]
        row = {"phase": "v1_reference", "model": name,
               "losses_kernels": kl, "losses_segment": sl,
               "grad_max_rel_err_per_leaf": max_err,
               "grad_norm_rel_err_per_leaf": norm_err,
               "grad_max_rel_err_vs_float64": max_rel(kg, exact),
               "segment_grad_max_rel_err_vs_float64": max_rel(sg, exact),
               "launches": list(kn), "launches_segment_run": list(sn)}
        if kn != want_launches or any(sn):
            raise RuntimeError(f"unexpected launches (want {want_launches} "
                               f"on the kernel run): {row}")
        loss_ok = all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(kl, sl))
        if name == "gat":
            row["grad_bars"] = ("max-relative 1e-4 on all leaves but the "
                                "last attn; last attn norm-wise 5e-4 "
                                "(leaky-ReLU kink flips)")
            grad_ok = max(max_err[:-1]) <= 1e-4 and norm_err[-1] <= 5e-4
        else:
            row["grad_bars"] = "norm-wise 1e-3 per leaf (ReLU flips)"
            grad_ok = max(norm_err) <= 1e-3
        emit(row)
        if not (loss_ok and grad_ok):
            raise RuntimeError(f"{name} through the v1 kernels disagrees "
                               f"with the segment path: {row}")


def phase_v1_main_path(torch, ds, graph, layout_build_s):
    """The v1 main path: ``train_full_graph`` on the synth-reddit-small
    v1 graph, 6 epochs each at lr 1e-2 and weight decay 5e-4, with GAT
    h512 (2 heads, 2 layers: per epoch 3 K7 launches in training and 3
    in the eval, 3 K8 and 3 K9) and GCN h256 (1 hidden layer, dropout
    0.5: per epoch 4 K3 launches forward, 2 on ``tiled_t``); each run
    once more under ``torch.profiler`` for its device time per epoch (the
    counts and host times are the first run's).  Returns the launches by
    kernel."""
    from gist_tpu_torch.models import gat, gcn
    from gist_tpu_torch.ops import gat_tiled as GT
    from gist_tpu_torch.ops import tiled_spmm as K3
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.full_graph import train_full_graph

    tc = TrainConfig(lr=1e-2, weight_decay=5e-4, n_epochs=6)
    runs = (("gat", gat, gat.GATConfig(ds.in_feats, 512, ds.n_classes,
                                       n_layers=2, n_heads=2)),
            ("gcn", gcn, gcn.GCNConfig(ds.in_feats, 256, ds.n_classes,
                                       n_layers=1, dropout=0.5)))
    launches = {}
    for name, model, cfg in runs:
        def run():
            return train_full_graph(ds, cfg, tc, model=model, graph=graph,
                                    device="cuda", verbose=False)
        torch.cuda.reset_peak_memory_stats()
        GT.reset_launches()
        K3.launches = 0
        r = run()
        torch.cuda.synchronize()
        counts = {"K3": K3.launches, "K7": GT.launches_fwd,
                  "K8": GT.launches_b1, "K9": GT.launches_b2}
        peak = torch.cuda.max_memory_allocated()
        _, prof = _profiled(torch, run)
        emit({"phase": "v1_main_path", "model": name, "epochs": tc.n_epochs,
              "layout_build_s": layout_build_s,
              "mean_epoch_s": r["mean_epoch_s"], "kteps": r["kteps"],
              "losses": r["losses"], "val_accs": r["val_accs"],
              "test_accs": r["test_accs"],
              "peak_memory_bytes": peak, "launches": counts,
              "device_per_epoch": _device_split(
                  prof, tc.n_epochs, {"K3": "tiled_spmm_kernel",
                                      "K7": "tiled_gat_fwd_kernel",
                                      "K8": "tiled_gat_b1_kernel",
                                      "K9": "tiled_gat_b2_kernel"}),
              "device_note": "a second run under torch.profiler: busy "
                             "time of training and eval, per epoch"})
        e = tc.n_epochs
        want = ({"K3": 0, "K7": 6 * e, "K8": 3 * e, "K9": 3 * e}
                if name == "gat" else
                {"K3": 6 * e, "K7": 0, "K8": 0, "K9": 0})
        if counts != want:
            raise RuntimeError(f"{name}: launches {counts}, want {want}")
        if not all(v == v and abs(v) < float("inf")
                   for v in r["losses"] + r["val_accs"]):
            raise RuntimeError(f"{name}: non-finite loss or accuracy")
        if not r["losses"][-1] < r["losses"][0]:
            raise RuntimeError(f"{name}: the loss did not fall: "
                               f"{r['losses']}")
        launches.update({k: v for k, v in counts.items() if v})
    return launches


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

    t0 = time.time()
    resume_launches = phase_uw_resume(torch, ds)
    emit({"phase": "uw_resume", "seconds": time.time() - t0})

    ds_r = load_dataset("synth-reddit-small")
    gat_sampler = ClusterSampler(dataclasses.replace(ds_r), 10, 4, seed=0,
                                 tiles=True)

    t0 = time.time()
    gat_rows = phase_gat_kernels(torch, device, gat_sampler)
    emit({"phase": "gat_kernels", "seconds": time.time() - t0})

    t0 = time.time()
    phase_gat_reference(torch, device, gat_sampler)
    emit({"phase": "gat_reference", "seconds": time.time() - t0})

    t0 = time.time()
    gat_launches = phase_gat_main_path(torch, dataclasses.replace(ds_r))
    emit({"phase": "gat_main_path", "seconds": time.time() - t0})
    del gat_sampler, sampler

    from gist_tpu_torch.graph import graph_from_edges
    t0 = time.time()
    v1_batch_rows = phase_v1_kernels(torch, device,
                                     dataclasses.replace(ds_r))
    emit({"phase": "v1_kernels", "seconds": time.time() - t0})

    t0 = time.time()
    v1_graph = graph_from_edges(ds_r.senders, ds_r.receivers, ds_r.n_nodes,
                                tiles=True, tile_mode="gather")
    v1_build_s = time.time() - t0
    _v1_shape(torch, "v1_full_graph", v1_graph)
    emit({"phase": "v1_full_graph", "graph_build_s": v1_build_s})
    v1_rows = _v1_kernel_rows(
        torch, device, v1_graph, "v1_full_graph",
        ((256, torch.float32), (41, torch.float32)),
        ((512, torch.float32), (41, torch.float32)), plain_reps=2)
    emit({"phase": "v1_full_graph", "seconds": time.time() - t0})

    t0 = time.time()
    phase_k3_plans(torch, device, v1_graph)
    emit({"phase": "k3_plans", "seconds": time.time() - t0})

    t0 = time.time()
    phase_v1_gat_plans(torch, device, v1_graph)
    emit({"phase": "v1_gat_plans", "seconds": time.time() - t0})

    t0 = time.time()
    v1_graph = v1_graph.to(device)
    phase_v1_reference(torch, device, ds_r, v1_graph)
    emit({"phase": "v1_reference", "seconds": time.time() - t0})

    t0 = time.time()
    v1_launches = phase_v1_main_path(torch, dataclasses.replace(ds_r),
                                     v1_graph, v1_build_s)
    emit({"phase": "v1_main_path", "seconds": time.time() - t0})
    del ds_r, v1_graph
    torch.cuda.empty_cache()

    g_amazon = graph_from_edges(ds.senders, ds.receivers, ds.n_nodes)
    t0 = time.time()
    split_rows, split_pair = phase_split_kernels(torch, device, g_amazon)
    emit({"phase": "split_kernels", "seconds": time.time() - t0})

    t0 = time.time()
    k2_launches = phase_split_path(torch, device, ds, g_amazon, split_pair)
    emit({"phase": "split_path", "seconds": time.time() - t0})
    del g_amazon, split_pair
    torch.cuda.empty_cache()

    t0 = time.time()
    ds_big = load_dataset("synth-reddit", self_loop=True)
    emit({"phase": "full_path", "dataset_s": time.time() - t0})
    full_launches, big_graph, chunked_rows = phase_full_path(
        torch, device, ds_big)
    emit({"phase": "full_path", "seconds": time.time() - t0})

    t0 = time.time()
    chunked_k4 = phase_gat_chunked(torch, device, ds_big, big_graph)
    emit({"phase": "gat_chunked", "seconds": time.time() - t0})
    del ds_big, big_graph
    torch.cuda.empty_cache()

    t0 = time.time()
    cli_launches = phase_uw_cli_chunked_eval(torch, device)
    emit({"phase": "uw_cli_chunked_eval", "seconds": time.time() - t0})

    main_case = cases["fwd F=256 float32"]
    full_case = chunked_rows["run_dedup_chunked fwd F=256 float32"]
    kernels = [{
        "name": "dedup_spmm", "route": "cuda",
        "source": "gist_tpu_torch/csrc/dedup_spmm.cu",
        "replaces": "gist_tpu/ops/pallas_spmm.py:66",
        "launches": launches + full_launches + resume_launches
        + cli_launches,
        "launches_by_path": {"sage_ultrawide": launches,
                             "full_graph_gcn": full_launches,
                             "uw_resume": resume_launches,
                             "uw_cli_synth_reddit": cli_launches},
        "max_abs_err": max(c["max_abs_err"] for c in [
            *cases.values(), *chunked_rows.values()]
            if c["case"].endswith("float32")),
        "ms": main_case["ms"], "call_ms": main_case["call_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "full_scale_pass": {k: full_case[k] for k in (
            "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}}]
    gat_kernels = (("K4", "gat_fwd", "gist_tpu/ops/pallas_gat.py:546"),
                   ("K5", "gat_bwd_b1", "gist_tpu/ops/pallas_gat.py:1015"),
                   ("K6", "gat_bwd_b2", "gist_tpu/ops/pallas_gat.py:1070"))
    split_main = split_rows["fwd CU=1024 F=100 float32"]
    kernels.append({
        "name": "split_spmm", "route": "cuda",
        "source": "gist_tpu_torch/csrc/split_spmm.cu",
        "replaces": "gist_tpu/ops/pallas_spmm.py:298",
        "launches": k2_launches,
        "launches_by_path": {"split_gcn_step": k2_launches},
        "max_abs_err": max(c["max_abs_err"] for c in split_rows.values()
                           if c["case"].endswith("float32")),
        "ms": split_main["ms"], "call_ms": split_main["call_ms"],
        "plain_ms": split_main["plain_ms"],
        "bound_ms": split_main["bound_ms"],
        "bound_by": split_main["bound_by"],
        "library_ms": split_main["library_ms"]})
    for (key, name, replaces), count in zip(gat_kernels, gat_launches):
        main_row = gat_rows[(key, "H=2 O=256 float32")]
        extra = chunked_k4 if key == "K4" else 0
        kernels.append({
            "name": name, "route": "cuda",
            "source": "gist_tpu_torch/csrc/gat_dedup.cu",
            "replaces": replaces, "launches": count + extra,
            "launches_by_path": {"gat_gist": count,
                                 **({"full_graph_gat": extra}
                                    if key == "K4" else {})},
            "max_abs_err": max(r["max_abs_err"] for (k, tag), r in
                               gat_rows.items()
                               if k == key and tag.endswith("float32")),
            "ms": main_row["ms"], "call_ms": main_row["call_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": None,
            "segment_ms": main_row["segment_ms"],
            **{k: main_row[k] for k in ("profiler_ms", "bitwise_repeat")
               if k in main_row}})
    v1_kernels = (
        ("K3", "tiled_spmm", "tiled_spmm.cu", "pallas_spmm.py:442",
         "fwd F=256 float32", "full_graph_gcn"),
        ("K7", "gat_tiled_fwd", "gat_tiled.cu", "pallas_gat.py:48",
         "D=512 float32", "full_graph_gat"),
        ("K8", "gat_tiled_bwd_b1", "gat_tiled.cu", "pallas_gat.py:238",
         "D=512 float32", "full_graph_gat"),
        ("K9", "gat_tiled_bwd_b2", "gat_tiled.cu", "pallas_gat.py:286",
         "D=512 float32", "full_graph_gat"))
    for key, name, source, replaces, case, path in v1_kernels:
        main_row = v1_rows[(key, case)]
        narrow = v1_rows.get((key, "D=41 float32"))   # K7-K9
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"gist_tpu_torch/csrc/{source}",
            "replaces": f"gist_tpu/ops/{replaces}",
            "launches": v1_launches[key],
            "launches_by_path": {path: v1_launches[key]},
            "max_abs_err": max(r["max_abs_err"] for (k, tag), r in
                               [*v1_rows.items(), *v1_batch_rows.items()]
                               if k == key and tag.endswith("float32")),
            "ms": main_row["ms"], "call_ms": main_row["call_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row.get("library_ms"),
            **{k: main_row[k] for k in ("segment_ms", "library_call_ms",
                                        "dz_library_ms", "profiler_ms",
                                        "bitwise_repeat", "gathered_tb_s")
               if k in main_row},
            **({"narrow_f": {
                d: {k: v1_rows[("K3", f"{d} F=41 float32")][k] for k in (
                    "ms", "call_ms", "library_ms", "library_call_ms",
                    "bound_ms", "bound_by", "max_abs_err", "rel_err",
                    "profiler_ms", "bitwise_repeat", "gathered_tb_s")}
                for d in ("fwd", "bwd")}} if key == "K3" else {}),
            **({"narrow_d": {k: narrow[k] for k in (
                "ms", "call_ms", "plain_ms", "segment_ms", "dz_library_ms",
                "bound_ms", "bound_by", "max_abs_err", "rel_err",
                "profiler_ms", "bitwise_repeat", "gathered_tb_s")
                if k in narrow}}
               if narrow else {})})
    emit({"kernels": kernels})
    emit({"phase": "total", "seconds": time.time() - t_all})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})


if __name__ == "__main__":
    main()
