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
   profiler time and two launches held bitwise equal, and K6 beside one
   ``torch.sparse.mm`` of its dz part alone (alpha in the values);
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
19. cluster_pp (run after phase 6): ``train_cluster_gcn`` with SAGE
    h256, 2 layers on phase 6's clusters, once with ``use_pp`` (K1 4
    launches a step, the first layer skipping its aggregation) and once
    for 5 epochs on multi-hot labels (sigmoid BCE must fall; micro-F1
    must beat predicting every label positive), counting K1 launches;
20. ist_simulation: ``cli.train_ist`` as a function, GCN h256, 2
    layers, K=4 on synth-reddit-small (self loops, random projection),
    10 epochs, loop and ``--fused``: the loop's per-round mean losses
    equal the fused rounds' within 1e-3 relative, and K1 launches 0
    times (the full graph carries no layout);
21. lsgd: ``cli.ist_distrib --lsgd`` as a function, SAGE h256, 2
    layers, K=4 on the GAT main path's clusters, 2 rounds, K1 5
    launches a step;
22. ist_gcn: ``train_ist_cluster(model=gcn, kind="gcn")``, GCN h256,
    K=2, 2 rounds on those clusters (K1 6 a step), and
    ``train_ist_ultrawide(model=gcn, kind="gcn")``, GCN h2048, 4 hidden
    layers, K=8, 1 round on the SAGE main path's clusters (K1 9 a step).
23. scan_batches (run after phase 16, as are 24 and 25: the phases
    that replay CUDA graphs follow every phase that reads kernel times
    from a ``torch.profiler`` trace, since traces taken after graphs had
    run were seen to miss kernel events): ``train_cluster_gcn`` with SAGE
    h256, 2 layers, dropout 0 on phase 6's clusters for 3 epochs, the
    per-batch loop against ``scan_batches=True`` (each epoch's 5 steps
    one CUDA-graph replay): losses within 1e-5 relative, K1 25 launches
    in every replay by the profiler, capture seconds, steady epoch
    seconds and device busy and idle share of an epoch of each; then K1
    captured alone on a batch of the stacked epoch and replayed against
    its plain walk;
24. sweep: ``python -m gist_tpu_torch.sweeps.run --sweep
    reddit-baseline --limit 1 --device cuda`` as a function, into
    ``scratch_chip/`` (40 epochs through ``scan_batches``); every record
    must read ``"status": "ok"``;
25. scan_epochs_v1: ``train_full_graph`` 6 epochs,
    the per-epoch loop against ``scan_epochs=3`` (an epoch, train and
    eval, one replay), (a) GCN h256 through K3 and (b) GAT h512 through
    K7-K9 on the v1 graph: losses within 1e-4 relative, accuracies
    equal, launches in every replay by the profiler equal to the loop's
    per epoch; then K3 and the chain K7 -> K8 -> K9 captured alone and
    replayed against their plain walks;
26. scan_epochs_chunked (run after phase 13): case (c), GCN h256 on the
    full-scale chunked graph (K1 4 C_f + 2 C_t a replay), the same
    checks, and K1 per chunk replayed against its plain walk;
27. sharded_graph (phases 27-29 run before phase 18, with ranks spawned
    on the one card; each prints its backend and world size): on two
    ranks (gloo: NCCL refuses two ranks on one device) the sharded
    aggregation of synth-reddit-small at F=602 against the flat one,
    forward and gradient (1e-5; K1 one forward and one transpose a rank),
    the bf16 halo within the rounding of the rows that crossed, the
    sharded GAT attention through K4 against the segment path (1e-5),
    one sharded SAGE step's gradients against one rank's (1e-5), K1
    against its plain walk on rank 0's interior layout, and
    ``cli.sharded_train`` for SAGE h256, GCN h256 and GAT h512 (2 heads),
    2 layers, 3 epochs, against the same CLI on one rank (nccl, in this
    process; 1e-5, GCN's later epochs 1e-4), with launches per rank, and
    a GCN run with a bf16 halo as the control that reads over those bars;
    on one rank also the sharded aggregation's time against the flat K1
    aggregation's;
28. ist_mesh: ``train_ist_cluster(mesh=...)`` (SAGE h256 and GAT h512,
    K=2, 2 ranks) and ``train_ist_ultrawide(sequential=False)`` (the
    main path's SAGE h2048 K=8, 8 ranks, 1 round) against their
    single-card loops: losses and accuracies within 1e-5, K1 and K4-K6
    per rank as derived;
29. ist_sharded_2d: ``cli.sharded_train --ist-subnets 2`` (SAGE h128,
    2 layers, 2 rounds of 8 steps) on a 2 x 2 mesh (4 ranks: the graph
    dim cut from 4 to 2) against S=2 x G=1 (2 ranks): K1 80 a rank, one
    step's gradients on the 2-D mesh's graph rows against one rank's
    (1e-5), the round-mean losses of the run and of the same run repeated
    within 4e-5 (round 1) and 1e-3 (round 2: Adam's steps amplify
    last-bit differences, and the run differs from itself as much), and
    a bf16-halo control that reads over round 1's bar.

Replayed outputs are held against the plain versions at 1e-5 relative to
the plain result's max, after the outputs were overwritten with NaN.

Kernel and library times: ``ms`` is device time per call, one CUDA
event pair around back-to-back calls queued ahead of the card
(:func:`_kernel_ms`); ``call_ms`` is one call between two events, the
wrapper's host work included (:func:`_call_ms`, the figure of earlier
runs).  Plain versions and model forwards keep one-call timing.

Then the kernel summary line, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero without a card or
without the package beside it.
"""

import contextlib
import json
import os
import shutil
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
            "count": torch.cuda.device_count(),
            "power": out.stdout.strip()}


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


def _k1_rows(torch, device, phase, g, widths):
    """K1 forward and transpose on the layout pair of batch graph ``g``
    at each (F, dtype) of ``widths``, against its plain version (fp32
    1e-5, bf16 1e-2 relative to the max), with times beside the bound
    and one ``torch.sparse.mm``; returns the rows by case, raising on
    any disagreement."""
    import numpy as np

    from gist_tpu_torch.ops import dedup_spmm as K

    if g.dedup is None or g.dedup.pos is not None:
        raise RuntimeError("expected an unreordered dedup layout")
    layouts = {"fwd": g.dedup.to(device), "bwd": g.dedup_t.to(device)}
    rng = np.random.default_rng(0)
    results = {}
    for f, dtype in widths:
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
            row = {"phase": phase, "case": f"{direction} F={f} "
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


def _k1_batch_rows(torch, device, phase, sampler, widths):
    """:func:`_k1_rows` on the next batch of ``sampler``, fp32 at each
    width, with the batch's size."""
    batch = sampler.make_batch(next(sampler.iter_node_ids()))
    emit({"phase": phase, "k1_batch_nodes": batch.n_real_nodes,
          "k1_batch_edges": batch.n_real_edges})
    return _k1_rows(torch, device, phase, batch.graph,
                    [(f, torch.float32) for f in widths])


def _k1_errors(rows):
    return {case: row["rel_err"] for case, row in rows.items()}


def phase_kernels(torch, device, sampler):
    batch = sampler.make_batch(next(sampler.iter_node_ids()))
    g = batch.graph
    if g.dedup is None or g.dedup.pos is not None:
        raise RuntimeError("expected an unreordered dedup layout")
    emit({"phase": "kernels", "batch_nodes": batch.n_real_nodes,
          "batch_edges": batch.n_real_edges, "n_pad": g.n_nodes,
          "tiles": g.dedup.num_tiles,
          "jobs": int(g.dedup.job_offsets[-1]),
          "w_blocks": list(g.dedup.w_blocks.shape),
          "w_nonzero": int(torch.count_nonzero(g.dedup.w_blocks))})
    return _k1_rows(torch, device, "kernels", g,
                    ((100, torch.float32), (256, torch.float32),
                     (256, torch.bfloat16)))


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


def _finite(values):
    return all(v == v and abs(v) < float("inf") for v in values)


def phase_cluster_pp(torch, ds):
    """Cluster-GCN with ``use_pp`` and with multi-hot labels, SAGE h256
    with 2 layers (the ``reddit-baseline`` width) on the clusters of the
    Cluster-GCN phase.  With ``use_pp`` the first layer neither
    aggregates nor needs a transpose: K1 4 times a step (2L - 2, L = 3
    weight layers) against 5 without.  The multi-hot run (labels a
    thresholded random projection of the features, one per class)
    trains 5 epochs with the sigmoid BCE (lr 3e-3, dropout 0): its loss
    must fall, and its last val micro-F1 must beat predicting every
    label positive (2p / (1 + p) at the val rows' positive share p), so
    a label or threshold mix-up fails.  Returns the K1 launches of both
    runs."""
    import dataclasses

    import numpy as np

    from gist_tpu_torch.models.sage import SAGEConfig
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.train.cluster import train_cluster_gcn
    from gist_tpu_torch.train.common import TrainConfig

    common = dict(psize=50, batch_size=10, normalize=True, use_f1=True,
                  verbose=False, device="cuda")
    dims = (ds.in_feats, 256, ds.n_classes)
    cfg = SAGEConfig(*dims, n_layers=2, dropout=0.2, use_pp=True)
    K.launches = 0
    t0 = time.time()
    pp = train_cluster_gcn(dataclasses.replace(ds), cfg,
                           TrainConfig(lr=1e-2, weight_decay=0.0,
                                       n_epochs=1), use_pp=True, **common)
    torch.cuda.synchronize()
    pp_s, pp_launches = time.time() - t0, K.launches

    w = np.random.default_rng(1).standard_normal((ds.in_feats,
                                                  ds.n_classes))
    multi = (ds.features @ w > 0).astype(np.float32)
    val_share = float(multi[ds.val_mask].mean())
    all_positive_f1 = 2 * val_share / (1 + val_share)
    cfg = SAGEConfig(*dims, n_layers=2, dropout=0.0)
    K.launches = 0
    t0 = time.time()
    mt = train_cluster_gcn(dataclasses.replace(ds, labels_multi=multi), cfg,
                           TrainConfig(lr=3e-3, weight_decay=0.0,
                                       n_epochs=5), **common)
    torch.cuda.synchronize()
    mt_s, mt_launches = time.time() - t0, K.launches
    emit({"phase": "cluster_pp", "use_pp_losses": pp["losses"],
          "use_pp_val_f1": pp["val_accs"], "use_pp_k1_launches": pp_launches,
          "use_pp_train_time_s": pp["train_time"], "use_pp_wall_s": pp_s,
          "multitask_losses": mt["losses"],
          "multitask_val_micro_f1": mt["val_accs"],
          "multitask_k1_launches": mt_launches,
          "multitask_train_time_s": mt["train_time"],
          "multitask_wall_s": mt_s, "classes": ds.n_classes,
          "positive_share": float(multi.mean()),
          "all_positive_val_f1": all_positive_f1})
    if pp_launches != 4 * 5:
        raise RuntimeError(f"use_pp: K1 launched {pp_launches} times, want "
                           f"4 a step (20)")
    if mt_launches != 5 * 25:
        raise RuntimeError(f"multitask: K1 launched {mt_launches} times, "
                           f"want 5 a step (125)")
    if not _finite(pp["losses"] + mt["losses"] + pp["val_accs"]
                   + mt["val_accs"]):
        raise RuntimeError("non-finite loss or score")
    if not mt["losses"][-1] < mt["losses"][0]:
        raise RuntimeError(f"the BCE loss did not fall: {mt['losses']}")
    if not all_positive_f1 < mt["val_accs"][-1] <= 1.0:
        raise RuntimeError(f"micro-F1 {mt['val_accs'][-1]} does not beat "
                           f"all-positive {all_positive_f1}")
    return pp_launches + mt_launches


def phase_ist_simulation(torch):
    """The GIST simulation through its entry point, ``cli.train_ist``
    as a function: GCN h256, 2 layers, K=4 (the ``small-ist`` widths,
    split input and output) on synth-reddit-small with self loops and
    the random projection, ``iter_per_site`` 5, 10 epochs, dropout 0;
    once in loop mode, once ``--fused``.  The full graph carries no
    layout, so K1 launches 0 times; the loop's losses averaged over each
    round equal the fused run's round losses within 1e-3 relative (the
    segment path's atomics move the last bits between the runs)."""
    from gist_tpu_torch.cli import train_ist
    from gist_tpu_torch.ops import dedup_spmm as K

    argv = ["--dataset", "synth-reddit-small", "--n-hidden", "256",
            "--n-layers", "2", "--num_subnet", "4", "--iter_per_site", "5",
            "--n-epochs", "10", "--dropout", "0", "--split_output", "True"]
    out, launches, walls = {}, 0, {}
    for mode, flags in (("loop", []), ("fused", ["--fused"])):
        K.launches = 0
        t0 = time.time()
        out[mode] = train_ist.main(argv + flags)
        torch.cuda.synchronize()
        walls[mode] = time.time() - t0
        launches += K.launches
    loop, fused = out["loop"], out["fused"]
    round_means = [sum(loop["losses"][i:i + 5]) / 5 for i in (0, 5)]
    diff = _rel_diff(round_means, fused["losses"])
    emit({"phase": "ist_simulation", "loop_losses": loop["losses"],
          "loop_round_means": round_means, "fused_losses": fused["losses"],
          "loss_rel_diff": diff, "tol": 1e-3,
          "loop_val_acc": loop["val_accs"], "fused_val_acc": fused["val_accs"],
          "loop_mean_epoch_s": loop["mean_epoch_s"],
          "fused_mean_epoch_s": fused["mean_epoch_s"],
          "loop_kteps": loop["kteps"], "fused_kteps": fused["kteps"],
          "wall_s": walls, "k1_launches": launches})
    if launches != 0:
        raise RuntimeError(f"K1 launched {launches} times on a graph "
                           f"without a layout")
    if len(loop["losses"]) != 10 or len(fused["losses"]) != 2:
        raise RuntimeError("expected 10 epochs and 2 fused rounds")
    if not _finite(loop["losses"] + fused["losses"] + loop["val_accs"]):
        raise RuntimeError("non-finite loss or accuracy")
    if not diff <= 1e-3:
        raise RuntimeError(f"loop and fused rounds differ by {diff}")


def phase_lsgd(torch, device, sampler):
    """The local-SGD baseline through its entry point, ``cli.ist_distrib
    --lsgd`` as a function: SAGE h256, 2 layers, K=4 (the ``reddit-lsgd``
    widths) on synth-reddit-small, psize 10, batch 4 (the GAT main
    path's clusters), ``iter_per_site`` 4, 2 rounds.  Every batch is
    over ``TILES_MIN_EDGES``, so each of the 4 workers' 4 steps a round
    runs K1 5 times (L forward, L - 1 transpose, L = 3).  Then K1 is
    held against its plain version, forward and transpose, at the widths
    this path aggregates (602 and 256) on a batch of ``sampler`` (the
    same clusters).  Returns the launches and those rows."""
    from gist_tpu_torch.cli import ist_distrib
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.sampler import TILES_MIN_EDGES

    K.launches = 0
    t0 = time.time()
    r = ist_distrib.main([
        "--dataset", "synth-reddit-small", "--n-hidden", "256",
        "--n-layers", "2", "--num_subnet", "4", "--iter_per_site", "4",
        "--psize", "10", "--batch-size", "4", "--n-epochs", "16",
        "--lr", "3e-2", "--dropout", "0.2", "--lsgd"])
    torch.cuda.synchronize()
    wall, launches = time.time() - t0, K.launches
    steps = len(r["losses"]) * 4 * 4
    k1 = _k1_batch_rows(torch, device, "lsgd", sampler, (602, 256))
    emit({"phase": "lsgd", "rounds": len(r["losses"]), "steps": steps,
          "losses": r["losses"], "val_acc": r["val_accs"],
          "round_wall_s": r["round_wall_s"],
          "edges_per_batch": r["edges_per_batch"],
          "edges_per_sec_jax_formula": r["edges_per_sec"],
          "wall_s": wall, "k1_launches": launches,
          "k1_rel_err": _k1_errors(k1)})
    if len(r["losses"]) != 2 or len(r["edges_per_batch"]) != 32:
        raise RuntimeError("expected 2 rounds of 16 batches")
    if not all(e >= TILES_MIN_EDGES for e in r["edges_per_batch"]):
        raise RuntimeError("a batch fell under the layout's edge threshold")
    if launches != 5 * steps:
        raise RuntimeError(f"K1 launched {launches} times, want 5 a step "
                           f"({5 * steps})")
    if not _finite(r["losses"] + r["val_accs"]):
        raise RuntimeError("non-finite loss or accuracy")
    return launches, k1


def _gcn_k1_per_step(cfg):
    """K1 launches of one GCN step on a batch with a layout: one forward
    a layer, and one transpose where the aggregated tensor needs a
    gradient, that is past layer 0, or at layer 0 when it projects
    before it aggregates (``graph_conv``: in > out)."""
    dims = cfg.layer_dims()
    return len(dims) + sum(1 for i, (d_in, d_out) in enumerate(dims)
                           if i > 0 or d_in > d_out)


def _gcn_k1_widths(cfg):
    """The widths K1 aggregates at in a GCN step: each layer's output
    width where it projects first (in > out), else its input width."""
    return sorted({min(d_in, d_out) for d_in, d_out in cfg.layer_dims()},
                  reverse=True)


def phase_ist_gcn(torch, device, ds_r, ds, r_sampler, a_sampler):
    """GCN in both IST trainers.  ``train_ist_cluster(model=gcn,
    kind="gcn")``: GCN h256, 2 layers, K=2 (the ``reddit-ist`` widths)
    on the lsgd phase's clusters, 2 rounds of 2 steps a subnet; each
    layer's aggregation feeds a gradient (layer 0 projects first, 602 >
    128; layer 1's input needs one; layer 2 projects first, 128 > 41),
    so K1 runs 6 times a step.  ``train_ist_ultrawide(model=gcn,
    kind="gcn")``: GCN h2048, 4 hidden layers, K=8 on the SAGE main
    path's clusters, 1 round of 5 steps a subnet, eval on the card;
    layer 0 aggregates the raw input first (100 < 256) and needs no
    transpose, so K1 runs 9 times a step.  Then K1 is held against its
    plain version, forward and transpose, at the widths each run
    aggregates (128 and 41; 256, 100 and 47) on a batch of its clusters
    (``r_sampler``, ``a_sampler``).  Returns the launches of both and
    those rows."""
    import dataclasses

    from gist_tpu_torch.models import gcn
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.sampler import TILES_MIN_EDGES
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.ist_cluster import train_ist_cluster
    from gist_tpu_torch.train.ist_ultrawide import train_ist_ultrawide

    ic_cfg = gcn.GCNConfig(ds_r.in_feats, 256, ds_r.n_classes, n_layers=2,
                           dropout=0.2)
    uw_cfg = gcn.GCNConfig(ds.in_feats, 2048, ds.n_classes, n_layers=4,
                           dropout=0.2)
    sub = dict(split_input=False, split_output=True)
    ic_per_step = _gcn_k1_per_step(ic_cfg.sub_config(num_subnet=2, **sub))
    uw_per_step = _gcn_k1_per_step(uw_cfg.sub_config(num_subnet=8, **sub))
    K.launches = 0
    t0 = time.time()
    ic = train_ist_cluster(
        dataclasses.replace(ds_r), ic_cfg,
        TrainConfig(lr=3e-2, weight_decay=0.0, n_epochs=4, num_subnet=2,
                    iter_per_site=2),
        psize=10, batch_size=4, model=gcn, kind="gcn", verbose=False,
        device="cuda")
    torch.cuda.synchronize()
    ic_s, ic_launches = time.time() - t0, K.launches
    ic_steps = len(ic["losses"]) * 2 * 2

    K.launches = 0
    t0 = time.time()
    uw = train_ist_ultrawide(
        dataclasses.replace(ds), uw_cfg,
        TrainConfig(lr=1e-2, weight_decay=0.0, n_epochs=8, num_subnet=8,
                    iter_per_site=5),
        psize=50, batch_size=10, normalize=True, use_f1=True,
        eval_on_cpu=False, model=gcn, kind="gcn", verbose=False,
        device="cuda")
    torch.cuda.synchronize()
    uw_s, uw_launches = time.time() - t0, K.launches
    uw_steps = len(uw["losses"]) * 8 * 5
    ic_k1 = _k1_batch_rows(
        torch, device, "ist_gcn", r_sampler,
        _gcn_k1_widths(ic_cfg.sub_config(num_subnet=2, **sub)))
    uw_k1 = _k1_batch_rows(
        torch, device, "ist_gcn", a_sampler,
        _gcn_k1_widths(uw_cfg.sub_config(num_subnet=8, **sub)))
    emit({"phase": "ist_gcn",
          "ist_cluster": {"rounds": len(ic["losses"]), "steps": ic_steps,
                          "losses": ic["losses"], "val_acc": ic["val_accs"],
                          "round_wall_s": ic["round_wall_s"],
                          "edges_per_batch": ic["edges_per_batch"],
                          "k1_launches": ic_launches,
                          "k1_per_step": ic_per_step, "wall_s": ic_s,
                          "k1_rel_err": _k1_errors(ic_k1)},
          "ultrawide": {"rounds": len(uw["losses"]), "steps": uw_steps,
                        "losses": uw["losses"], "val_f1": uw["val_accs"],
                        "round_wall_s": uw["round_wall_s"],
                        "host_prep_s": uw["host_prep_s"],
                        "device_sync_s": uw["device_sync_s"],
                        "eval_wall_s": uw["eval_wall_s"],
                        "edges_per_batch": uw["edges_per_batch"],
                        "k1_launches": uw_launches,
                        "k1_per_step": uw_per_step, "wall_s": uw_s,
                        "k1_rel_err": _k1_errors(uw_k1)}})
    if (len(ic["losses"]), len(uw["losses"])) != (2, 1):
        raise RuntimeError("expected 2 IST-cluster rounds and 1 ultra-wide "
                           "round")
    if not all(e >= TILES_MIN_EDGES for e in
               ic["edges_per_batch"] + uw["edges_per_batch"]):
        raise RuntimeError("a batch fell under the layout's edge threshold")
    if ic_launches != ic_per_step * ic_steps:
        raise RuntimeError(f"IST cluster GCN: K1 launched {ic_launches} "
                           f"times, want {ic_per_step} a step")
    if uw_launches != uw_per_step * uw_steps:
        raise RuntimeError(f"ultra-wide GCN: K1 launched {uw_launches} "
                           f"times, want {uw_per_step} a step")
    if not _finite(ic["losses"] + uw["losses"] + ic["val_accs"]
                   + uw["val_accs"]):
        raise RuntimeError("non-finite loss or accuracy")
    return ic_launches, uw_launches, {
        **{("ist_cluster_gcn", c): r for c, r in ic_k1.items()},
        **{("ultrawide_gcn", c): r for c, r in uw_k1.items()}}


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
             nbytes, flops, dtype, kernel_name=None, dz_library=None):
    """Time a GAT kernel beside its plain version, the segment composite
    and, where one is given, the ``dz_library`` call (a library call of
    part of the function, so ``library_ms`` stays None); raise unless every
    output is finite and within ``tol`` of the plain result relative to
    its max.  With ``kernel_name`` (a redesigned kernel) also its
    profiler time, and raise unless two launches give the same bits."""
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
           "library_ms": None,
           "dz_library_ms": (None if dz_library is None
                             else _kernel_ms(torch, dz_library)),
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
    single PyTorch call computes these functions, but K6's
    ``dz_library_ms`` times one ``torch.sparse.mm`` of its dz part alone
    (the transpose pattern with the head's alpha in its values, times G;
    as K9's row does).  Each row prints its
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
        from gist_tpu_torch.ops import gat_tiled as GT
        got_b2 = G.gat_bwd_b2(*b2_args)
        dz_library = _alpha_spmm(
            torch, GT, g, device, sh, dh, G._to_nodes(tf, m0, n).float(),
            G._to_nodes(tf, l0, n).float(), slope, gh, tol_b, got_b2[0],
            name="K6")
        rows[("K6", tag)] = _gat_row(
            torch, "K6", tag, got_b2,
            G.gat_bwd_b2_reference(*b2_args), tol_b,
            lambda: G.gat_bwd_b2(*b2_args),
            lambda: G.gat_bwd_b2_reference(*b2_args), seg_bwd,
            _layout_bytes(tt) + 2 * rt * o * item + rt * 8 + n * o * 4
            + n * 16, nnz_t * (4 * o + 10), dtype,
            kernel_name="gat_bwd_b2_kernel", dz_library=dz_library)
        del got_b2, dz_library

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
                want, name="K9"):
    """The dz part of K9 (or K6) as one library call: ``torch.sparse.mm``
    of the transpose pattern (rows the original senders, columns the
    original receivers, node order) with each edge's alpha in its
    values, times G.  The matrix is built once and not timed; raise
    unless its product is within ``tol`` of ``want`` (the kernel's dz)
    relative to its max."""
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
                           f"{name}'s dz")
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


# --- CUDA-graph capture: one dispatch an epoch --------------------------------

# the sleep kernel that opens a replay's trace: ~0.1 ms at ~2 GHz
SLEEP_CYCLES = 200_000
REPLAY_COUNT_NOTE = (
    "a kernel captured alone: its outputs, set to NaN before the replay, "
    "read its plain version's values after it, so it ran in the replay; "
    "the trace's count of it is printed but not held (traces of a "
    "one-kernel replay were seen to miss that kernel's event)")


@contextlib.contextmanager
def _replay_traces(torch):
    """Inside, every ``Captured.replay`` of the port runs under a
    ``torch.profiler`` trace of its own (the copy of its new inputs, the
    replay and a synchronise);
    yields the list of traces, one a replay.  A replay calls no Python,
    so these traces are how a run counts the kernels a replay runs."""
    from gist_tpu_torch.train import capture
    traces = []
    real = capture.Captured.replay

    def replay(self, values=None):
        def lead_and_replay():
            # the trace opens on a short sleep kernel: events of a
            # replay's start were seen missing from its trace without it
            torch.cuda._sleep(SLEEP_CYCLES)
            real(self, values)
        traces.append(_profiled(torch, lead_and_replay)[1])
    capture.Captured.replay = replay
    try:
        yield traces
    finally:
        capture.Captured.replay = real


@contextlib.contextmanager
def _epoch_traces(torch):
    """Inside, each epoch of ``train_cluster_gcn``'s per-batch loop (its
    ``prefetch`` stream of batches, from the first step enqueued to the
    last one done) runs under a ``torch.profiler`` trace of its own;
    yields the list of traces, one an epoch (eval excluded)."""
    from torch.profiler import ProfilerActivity, profile

    from gist_tpu_torch.train import cluster
    traces = []
    real = cluster.prefetch

    def traced(iterable, *a, **kw):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield from real(iterable, *a, **kw)
            torch.cuda.synchronize()
        traces.append(prof)
    cluster.prefetch = traced
    try:
        yield traces
    finally:
        cluster.prefetch = real


def _count(prof, name):
    """Device events of a trace whose names hold ``name``."""
    return sum(1 for e in _device_events(prof) if name in e.name)


def _counts_match(counts, want, n):
    """True when ``n`` replays' kernel counts from their traces show
    ``want`` launches a replay: the largest count equals it and every
    replay shows the kernel.  A trace can miss events (one replay's
    trace read 33 of 36), so a count under ``want`` in some replay alone
    does not fail; the counter at capture (the warm-up's launches and
    the captured ones) holds the exact number of captured launches."""
    return len(counts) == n and max(counts) == want and min(counts) > 0


def _busy(prof):
    """(busy ms, span ms) of a trace's device events, the leading sleep
    kernel (``spin_kernel``) left out."""
    ev = [e for e in _device_events(prof) if "spin_kernel" not in e.name]
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    span = (max(e.time_range.end for e in ev)
            - min(e.time_range.start for e in ev)) / 1e3 if ev else 0.0
    return busy, span


def _unit_device(traces, epoch_s):
    """Device busy and span per trace (one an epoch or a replay), the
    idle share inside the span and the idle share of the epoch's wall
    (``epoch_s``, the trainer's steady epoch seconds)."""
    busy = statistics.median(_busy(p)[0] for p in traces)
    span = statistics.median(_busy(p)[1] for p in traces)
    return {"device_busy_ms": busy, "device_span_ms": span,
            "idle_share_of_span": 1 - busy / span if span else None,
            "epoch_s": epoch_s,
            "idle_share_of_epoch": 1 - busy / 1e3 / epoch_s
            if epoch_s else None}


def _replay_check(torch, launch, plain, tol=1e-5):
    """Capture ``launch()`` (a tuple of output tensors) into a CUDA graph
    with the port's capture, overwrite its outputs with NaN, replay it
    once under ``torch.profiler``, and hold each output against
    ``plain(outputs)``, the plain versions' results on the same inputs
    (given the replay's outputs, for the inputs a chain of kernels hands
    on).  An output that reads its plain value after the replay was
    written by the replay.  Returns (the largest error relative to each
    plain result's max, the replay's trace); raises above ``tol``."""
    from gist_tpu_torch.train.capture import Captured
    held = {}
    run = Captured(lambda: held.update(out=launch()))
    for t in held["out"]:
        t.fill_(float("nan"))
    torch.cuda.synchronize()

    _, prof = _profiled(torch, run.replay)
    got = held["out"]
    want = plain(got)
    err = 0.0
    for a, b in zip(got, want):
        if not torch.isfinite(a.float()).all():
            raise RuntimeError("a replayed output is not finite")
        err = max(err, float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp(min=1e-30)))
    if not err <= tol:
        raise RuntimeError(f"a replayed output is {err} off its plain "
                           f"version (tol {tol})")
    return err, prof


def phase_scan_batches(torch, ds, sampler):
    """``train_cluster_gcn`` with SAGE h256, 2 layers, dropout 0 on the
    main path's clusters (psize 50, batch 10, K1 on every batch, 5
    launches a step), 3 epochs, per-batch loop against
    ``scan_batches=True``: losses within 1e-5 relative (K1 sums in a
    fixed order); K1 in every replay 5 steps x 5 from the profiler, and
    the counter at capture (warm-up step and captured steps); capture
    seconds, steady epoch seconds and device busy and idle share of one
    epoch of each (a second run of each under the profiler: the loop's
    epochs, the scan's replays).  Then K1 captured alone on one batch of
    the stacked epoch and replayed, against its plain walk (1e-5
    relative), at F=100 (the features) and F=256 (the hidden width).
    Returns (K1's launches in the scanned run, the replay rows)."""
    import dataclasses

    import numpy as np

    from gist_tpu_torch.models.sage import SAGEConfig
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.sampler import stack_batches
    from gist_tpu_torch.train import capture
    from gist_tpu_torch.train.cluster import train_cluster_gcn
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.ist_cluster import _RoundCollector

    cfg = SAGEConfig(100, 256, 47, n_layers=2, dropout=0.0)
    tc = TrainConfig(lr=1e-2, weight_decay=0.0, n_epochs=3)
    steps, per_step = 5, 5

    parts = os.path.join(HERE, "scratch_chip", "partitions")
    shutil.rmtree(parts, ignore_errors=True)   # made anew by this run

    def run(scan):
        return train_cluster_gcn(
            dataclasses.replace(ds), cfg, tc, psize=50, batch_size=10,
            normalize=True, use_f1=True, cache_dir=parts, scan_batches=scan,
            verbose=False, device="cuda")
    K.launches = 0
    loop = run(False)
    torch.cuda.synchronize()
    loop_launches = K.launches
    capture.reset_stats()
    K.launches = 0
    scan = run(True)
    torch.cuda.synchronize()
    at_capture, stats = K.launches, dict(capture.stats)
    with _epoch_traces(torch) as loop_traces:
        run(False)
    capture.reset_stats()
    with _replay_traces(torch) as replay_traces:
        run(True)
    per_replay = [_count(p, "dedup_spmm_kernel") for p in replay_traces]
    launches = stats["captures"] * per_step + stats["replays"] * steps \
        * per_step
    rel = _rel_diff(scan["losses"], loop["losses"])
    row = {"phase": "scan_batches", "epochs": tc.n_epochs,
           "loop_losses": loop["losses"], "scan_losses": scan["losses"],
           "loss_max_rel_diff": rel, "loop_val_f1": loop["val_accs"],
           "scan_val_f1": scan["val_accs"],
           "captures": stats["captures"], "capture_s": stats["capture_s"],
           "replays": stats["replays"],
           "k1_per_replay_profiler": per_replay,
           "k1_counter_at_capture": at_capture,
           "k1_loop_launches": loop_launches, "k1_scan_launches": launches,
           "loop_steady_epoch_s": loop["steady_epoch_s"],
           "scan_steady_epoch_s": scan["steady_epoch_s"],
           "loop_epoch_device": _unit_device(loop_traces[1:],
                                             loop["steady_epoch_s"]),
           "scan_epoch_device": _unit_device(replay_traces[1:],
                                             scan["steady_epoch_s"]),
           "device_note": "second runs under torch.profiler: one trace an "
                          "epoch of the loop (its steps and their batches' "
                          "copies), one a replay of the scan (the stack's "
                          "copy and the replay); epoch 0 left out"}
    emit(row)
    if loop_launches != tc.n_epochs * steps * per_step:
        raise RuntimeError(f"loop: K1 launched {loop_launches} times")
    if not _counts_match(per_replay, steps * per_step, tc.n_epochs):
        raise RuntimeError(f"K1 per replay {per_replay}, want "
                           f"{steps * per_step} in each of {tc.n_epochs}")
    if at_capture != stats["captures"] * (1 + steps) * per_step:
        raise RuntimeError(f"K1's counter read {at_capture} after "
                           f"{stats['captures']} captures")
    if not rel <= 1e-5:
        raise RuntimeError(f"scanned losses {rel} off the loop's")

    collector = _RoundCollector(sampler, steps, ids_only=True)
    stacked = stack_batches(collector.collect())
    g, ids = stacked.views({k: v.to("cuda")
                            for k, v in stacked.tensors.items()})[0]
    if g.dedup is None:
        raise RuntimeError("the stacked batch carries no dedup layout")
    d = g.dedup
    rng = np.random.default_rng(0)
    rows = {}
    for f in (100, 256):
        x = torch.from_numpy(rng.standard_normal(
            (g.n_nodes, f)).astype(np.float32)).cuda()
        err, prof = _replay_check(
            torch, lambda: (K.dedup_spmm(d.job_offsets, d.w_blocks,
                                         d.u_senders, x),),
            lambda got: (K.dedup_spmm_reference(
                d.job_offsets, d.w_blocks, d.u_senders, x),))
        rows[f"fwd F={f}"] = {"rel_err": err,
                              "k1_in_trace": _count(prof,
                                                     "dedup_spmm_kernel")}
    emit({"phase": "scan_batches", "k1_replay_vs_plain": rows,
          "batch_nodes": g.n_nodes, "batch_jobs": int(d.w_blocks.shape[0]),
          "note": REPLAY_COUNT_NOTE})
    return launches, rows


def _scan_epochs_case(torch, name, ds, model, cfg, graph, counters,
                      per_epoch, tol=1e-4):
    """``train_full_graph`` on ``graph`` for 6 epochs (lr 1e-2, weight
    decay 5e-4, the LR schedule), the per-epoch loop against
    ``scan_epochs=3``: losses within ``tol`` relative, accuracies equal;
    ``counters`` (label -> (function reading a launch counter, kernel
    name in the trace)) against ``per_epoch`` (label -> launches an
    epoch, train and eval) in the loop, at capture (the warm-up epoch
    and the captured one) and in every replay from the profiler; mean
    epoch seconds and device busy and idle share of an epoch of each
    (second runs under the profiler).  Returns the launches by label in
    the scanned run."""
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.ops import gat_tiled as GT
    from gist_tpu_torch.ops import tiled_spmm as K3
    from gist_tpu_torch.train import capture
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.full_graph import train_full_graph

    tc = TrainConfig(lr=1e-2, weight_decay=5e-4, n_epochs=6,
                     lr_schedule=True)

    def reset():
        K.launches = K3.launches = 0
        GT.reset_launches()

    def run(k):
        return train_full_graph(ds, cfg, tc, model=model, graph=graph,
                                scan_epochs=k, device="cuda", verbose=False)

    def read():
        return {lab: fn() for lab, (fn, _) in counters.items()}
    reset()
    loop = run(0)
    torch.cuda.synchronize()
    loop_counts = read()
    reset()
    capture.reset_stats()
    scan = run(3)
    torch.cuda.synchronize()
    at_capture, stats = read(), dict(capture.stats)
    _, loop_prof = _profiled(torch, lambda: run(0))
    with _replay_traces(torch) as traces:
        run(3)
    per_replay = {lab: [_count(p, kname) for p in traces]
                  for lab, (_, kname) in counters.items()}
    rel = _rel_diff(scan["losses"], loop["losses"])
    loop_busy, loop_span = _busy(loop_prof)
    e = tc.n_epochs
    emit({"phase": "scan_epochs", "case": name, "epochs": e,
          "scan_epochs": scan["scan_epochs"],
          "loop_losses": loop["losses"], "scan_losses": scan["losses"],
          "loss_max_rel_diff": rel, "loop_val_accs": loop["val_accs"],
          "scan_val_accs": scan["val_accs"],
          "loop_test_accs": loop["test_accs"],
          "scan_test_accs": scan["test_accs"],
          "launches_per_epoch_want": per_epoch, "loop_launches": loop_counts,
          "counter_at_capture": at_capture, "per_replay_profiler": per_replay,
          "captures": stats["captures"], "capture_s": stats["capture_s"],
          "replays": stats["replays"],
          "loop_mean_epoch_s": loop["mean_epoch_s"],
          "scan_mean_epoch_s": scan["mean_epoch_s"],
          "loop_epoch_device": {
              "device_busy_ms": loop_busy / e,
              "idle_share_of_span": 1 - loop_busy / loop_span
              if loop_span else None},
          "scan_epoch_device": _unit_device(traces, scan["mean_epoch_s"]),
          "device_note": "second runs under torch.profiler: the loop's "
                         "whole run (train and eval each epoch, per "
                         "epoch), one trace a replay of the scan (one "
                         "epoch, train and eval); the loop's mean_epoch_s "
                         "times the train step, the scan's the epoch"})
    if stats["captures"] != 1 or stats["replays"] != e:
        raise RuntimeError(f"{name}: {stats}, want 1 capture and {e} "
                           f"replays")
    for lab, want in per_epoch.items():
        if loop_counts[lab] != e * want:
            raise RuntimeError(f"{name}: loop launched {lab} "
                               f"{loop_counts[lab]} times, want {e * want}")
        if at_capture[lab] != 2 * want:
            raise RuntimeError(f"{name}: {lab}'s counter read "
                               f"{at_capture[lab]} at capture, want "
                               f"{2 * want}")
        if not _counts_match(per_replay[lab], want, e):
            raise RuntimeError(f"{name}: {lab} per replay "
                               f"{per_replay[lab]}, want {want}")
    if not rel <= tol:
        raise RuntimeError(f"{name}: scanned losses {rel} off the loop's")
    for k in ("val_accs", "test_accs"):
        if scan[k] != loop[k]:
            raise RuntimeError(f"{name}: scanned {k} differ from the loop's")
    return {lab: want + e * want for lab, want in per_epoch.items()}


def phase_scan_epochs_v1(torch, device, ds, graph):
    """``scan_epochs`` cases (a) GCN h256 (K3: 4 launches forward and 2
    transpose an epoch) and (b) GAT h512, 2 heads, 2 layers (K7 6, K8 3,
    K9 3 an epoch) on the full synth-reddit-small v1 graph; then K3 and
    the chain K7 -> K8 -> K9 captured alone and replayed on that graph
    at F=256 and D=512, against their plain walks (1e-5 relative).
    Returns (launches by kernel in the scanned runs, the replay rows)."""
    import numpy as np

    from gist_tpu_torch.models import gat, gcn
    from gist_tpu_torch.ops import gat_tiled as GT
    from gist_tpu_torch.ops import tiled_spmm as K3

    launches = _scan_epochs_case(
        torch, "a_v1_gcn_h256", ds, gcn,
        gcn.GCNConfig(ds.in_feats, 256, ds.n_classes, n_layers=1,
                      dropout=0.0), graph,
        {"K3": (lambda: K3.launches, "tiled_spmm_kernel")}, {"K3": 6})
    launches.update(_scan_epochs_case(
        torch, "b_v1_gat_h512", ds, gat,
        gat.GATConfig(ds.in_feats, 512, ds.n_classes, n_layers=2,
                      n_heads=2), graph,
        {"K7": (lambda: GT.launches_fwd, "tiled_gat_fwd_kernel"),
         "K8": (lambda: GT.launches_b1, "tiled_gat_b1_kernel"),
         "K9": (lambda: GT.launches_b2, "tiled_gat_b2_kernel")},
        {"K7": 6, "K8": 3, "K9": 3}))

    rng = np.random.default_rng(0)
    n = graph.n_nodes

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(device)
    rows = {}
    x = randn(n, 256)
    for direction, t in (("fwd", graph.tiled), ("bwd", graph.tiled_t)):
        err, prof = _replay_check(
            torch, lambda: (K3.tiled_spmm(t, x),),
            lambda got: (K3.tiled_spmm_reference(t, x),))
        rows[("K3", f"{direction} F=256")] = {
            "rel_err": err, "in_trace": _count(prof, "tiled_spmm_kernel")}
    slope, tf, tt = 0.01, graph.tiled, graph.tiled_t
    z, src, dst, gg = randn(n, 512), randn(n), randn(n), randn(n, 512)

    def chain():
        out, m, l = GT.gat_tiled_fwd(tf, z, src, dst, slope)
        ds_, ddst = GT.gat_tiled_bwd_b1(tf, z, src, dst, m, l, gg, slope)
        dz, dsrc = GT.gat_tiled_bwd_b2(tt, ds_, gg, src, dst, m, l, slope)
        return out, l, m, ds_, ddst, dz, dsrc

    def plain(got):
        _, l, m, ds_ = got[:4]
        b1 = GT.gat_tiled_bwd_b1_reference(tf, z, src, dst, m, l, gg, slope)
        b2 = GT.gat_tiled_bwd_b2_reference(tt, ds_, gg, src, dst, m, l,
                                           slope)
        out_p, m_p, l_p = GT.gat_tiled_fwd_reference(tf, z, src, dst, slope)
        has = l_p > 0
        # empty rows hold K7's -1e30 sentinel: compare m on the rows with
        # edges (in place, after the walks that read it)
        m.copy_(torch.where(has, m, 0.0))
        return (out_p, l_p, torch.where(has, m_p, 0.0), *b1, *b2)
    err, prof = _replay_check(torch, chain, plain)
    rows[("K7-K9", "D=512")] = {
        "rel_err": err, **{k: _count(prof, name) for k, name in (
            ("K7", "tiled_gat_fwd_kernel"), ("K8", "tiled_gat_b1_kernel"),
            ("K9", "tiled_gat_b2_kernel"))}}
    emit({"phase": "scan_epochs", "replay_vs_plain": {
        f"{k} {c}": v for (k, c), v in rows.items()},
        "note": REPLAY_COUNT_NOTE})
    return launches, rows


def phase_scan_epochs_chunked(torch, device, ds, graph):
    """``scan_epochs`` case (c): GCN h256, dropout 0, on the full-scale
    path's chunked graph (K1 once per chunk: 4 C_f + 2 C_t launches an
    epoch); then K1 per chunk (``run_dedup_chunked`` on ``dedup_c`` at
    F=256) captured alone and replayed, against the chunked plain walk
    (1e-5 relative).  Returns (K1's launches in the scanned run, the
    replay row)."""
    import numpy as np

    from gist_tpu_torch.models import gcn
    from gist_tpu_torch.ops import dedup_spmm as K

    cf, ct = graph.dedup_c.n_chunks, graph.dedup_c_t.n_chunks
    launches = _scan_epochs_case(
        torch, "c_chunked_gcn_h256", ds, gcn,
        gcn.GCNConfig(ds.in_feats, 256, ds.n_classes, n_layers=1,
                      dropout=0.0), graph,
        {"K1": (lambda: K.launches, "dedup_spmm_kernel")},
        {"K1": 4 * cf + 2 * ct})["K1"]
    rng = np.random.default_rng(0)
    t, n = graph.dedup_c, graph.n_nodes
    x = torch.from_numpy(rng.standard_normal((n, 256)).astype(
        np.float32)).to(device)
    err, prof = _replay_check(
        torch, lambda: (K.run_dedup_chunked(t, x, n),),
        lambda got: (_chunked_plain(torch, t, x, n),))
    row = {"rel_err": err, "k1_in_trace": _count(prof, "dedup_spmm_kernel"),
           "n_chunks": cf}
    emit({"phase": "scan_epochs", "case": "c_chunked_gcn_h256",
          "k1_replay_vs_plain": row, "note": REPLAY_COUNT_NOTE})
    return launches, row


def phase_sweep(torch):
    """``python -m gist_tpu_torch.sweeps.run --sweep reddit-baseline
    --limit 1 --device cuda`` as a function, into ``scratch_chip/``
    (gitignored): SAGE h256, 1 layer, synth-reddit-small, psize 1500,
    batch 20, 40 epochs through ``scan_batches=True``.  The runner records a failure instead
    of raising, so the phase fails unless every record reads
    ``"status": "ok"`` with finite losses.  Prints the captures and
    replays, ``summarize``'s first row and the wall."""
    from gist_tpu_torch.sweeps import run
    from gist_tpu_torch.train import capture

    out = os.path.join(HERE, "scratch_chip", "sweep_reddit_baseline.jsonl")
    if os.path.exists(out):
        os.remove(out)       # else the runner resumes and runs nothing
    capture.reset_stats()
    t0 = time.time()
    records, rows = run.main(["--sweep", "reddit-baseline", "--limit", "1",
                              "--device", "cuda", "--out", out])
    wall = time.time() - t0
    with open(out) as f:
        lines = [json.loads(line) for line in f]
    bad = [r for r in lines if r.get("status") != "ok"]
    emit({"phase": "sweep", "records": len(lines), "wall_s": wall,
          "run_wall_s": [r.get("wall_s") for r in lines],
          "captures": capture.stats["captures"],
          "capture_s": capture.stats["capture_s"],
          "replays": capture.stats["replays"],
          "summarize_first_row": rows[0] if rows else None,
          "steady_epoch_s": [r["result"]["steady_epoch_s"]
                             for r in lines if "result" in r],
          "errors": [r.get("error") for r in bad]})
    if not lines or bad or len(records) != 1:
        raise RuntimeError(f"sweep records not all ok: {bad or lines}")
    if not _finite(lines[0]["result"]["losses"]):
        raise RuntimeError("sweep: non-finite loss")
    if capture.stats["replays"] != 40:
        raise RuntimeError(f"sweep: {capture.stats['replays']} replays for "
                           f"40 epochs")


# ---------------------------------------------------------------------------
# Multi-rank phases (27-29): ranks spawned on the one card
# ---------------------------------------------------------------------------

def _backend(torch, world):
    """The collectives' backend of a world of ``world`` ranks on this
    host's cards: nccl when every rank has a card of its own; gloo when
    ranks share one, since NCCL refuses two ranks of one communicator on
    one device ("Duplicate GPU detected", NCCL 2.28.9 on the H100)."""
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def _rank_main(rank, world, work, backend, job, args):
    """A spawned rank: the process group (file rendezvous) and the
    launcher's environment, as torchrun would set them, then ``job``;
    its result is pickled to ``work``."""
    import pickle

    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.cuda.set_device(rank % torch.cuda.device_count())
    # a process's first optimizer step imports torch._dynamo; import it
    # here, so that its seconds fall outside the jobs' clocks
    t0 = time.time()
    import torch._dynamo  # noqa: F401
    warm_s = time.time() - t0
    dist.init_process_group(backend, init_method=f"file://{work}/rdv",
                            rank=rank, world_size=world)
    try:
        res = globals()[job](torch, rank, world, **args)
        with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump((res, warm_s), f)
    finally:
        dist.destroy_process_group()


def _spawn(torch, world, job, **args):
    """Run ``job`` on ``world`` ranks of this card (each its own process,
    started with ``spawn``); returns (backend, [each rank's result],
    seconds).  The kernels were built by the build phase, so no rank
    compiles."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp
    backend = _backend(torch, world)
    work = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    torch.cuda.empty_cache()
    t0 = time.time()
    mp.start_processes(_rank_main, args=(world, work, backend, job, args),
                       nprocs=world, start_method="spawn")
    out, warm = [], []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            res, warm_s = pickle.load(f)
        out.append(res)
        warm.append(warm_s)
    shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "spawn", "job": job, "world": world, "backend": backend,
          "seconds": time.time() - t0, "dynamo_import_s": warm})
    return backend, out, time.time() - t0


def _counts():
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.ops import gat_dedup as G
    return {"K1": K.launches, "K4": G.launches_fwd, "K5": G.launches_b1,
            "K6": G.launches_b2}


def _reset_counts():
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.ops import gat_dedup as G
    K.launches = 0
    G.reset_launches()


# The sharded CLI runs of phase 27 (synth-reddit-small, 3 epochs, dropout
# 0) and the launches one rank makes in each: an epoch is one training
# step and one sharded infer.  SAGE (3 weight layers): K1 3 forward, 2
# transpose (layer 0's input takes no gradient), infer 3 -> 8 an epoch.
# GCN (3 layers): 3 forward and 3 transpose (layers 0 and 2 project
# first, 602 > 256 and 256 > 41, so every aggregated tensor takes a
# gradient), infer 3 -> 9.  GAT (2 layers): K4 once a layer forward and
# in the infer, none in the backward (the exact segment recompute) -> 4.
SHARDED_CLI = {
    "sage": (["--model", "sage", "--n-hidden", "256"], {"K1": 8}),
    "gcn": (["--model", "gcn", "--n-hidden", "256"], {"K1": 9}),
    "gat": (["--model", "gat", "--n-hidden", "512", "--n-heads", "2"],
            {"K4": 4}),
}
SHARDED_EPOCHS = 3
# Each epoch's bar on the D=2 CLI losses against D=1's (relative).  On
# the H100 SAGE and GAT read at most 1.3e-7.  GCN's second and third
# epochs read 0 and 1.4e-6 in some runs of the same code and 2.3e-5 and
# 3.7e-5 in others (the boundary sums' atomics, whose last bits Adam's
# first steps, lr times the sign of each gradient entry, turn into loss
# differences); a GCN run with a bf16 halo reads 1.2e-5, 4.7e-4 and
# 1.8e-4, and the phase checks that this control reads over the bars.
SHARDED_CLI_BARS = {"sage": [1e-5] * 3, "gcn": [1e-5, 1e-4, 1e-4],
                    "gat": [1e-5] * 3}
# Phase 29's bar on each round's mean loss, G=2 against G=1 (relative).
# A round is 8 Adam steps, whose first steps (lr times the sign of each
# gradient entry) turn last-bit differences of the summation order into
# loss differences.  On the H100 round 1 reads 1.3-1.5e-5 at fp32 and
# 8.1e-5 with a bf16 halo: its bar sits between, and the phase checks
# the bf16 control stays over it.  Round 2 of the G=2 run differs from
# the same run repeated by 3.1e-4, as much as from G=1 (1.7e-4 to
# 4.8e-4); a bf16 halo reads 1.0e-3 there, so round 2 cannot tell the
# two apart and its bar only sits over that spread.
IST_2D_BARS = [4e-5, 1e-3]


def _loss_rel(got, ref):
    """Each epoch's |got - ref| / |ref|."""
    return [abs(a - b) / abs(b) for a, b in zip(got, ref)]


def _sharded_cli(torch, model, extra=()):
    """``cli.sharded_train`` as a function in the initialised group:
    (result, launches of this rank, seconds)."""
    from gist_tpu_torch.cli import sharded_train
    argv, _ = SHARDED_CLI[model]
    _reset_counts()
    t0 = time.time()
    r = sharded_train.main(["--dataset", "synth-reddit-small",
                            "--n-layers", "2", "--dropout", "0",
                            "--n-epochs", str(SHARDED_EPOCHS)] + argv
                           + list(extra))
    torch.cuda.synchronize()
    if not r["interior_tiles"]:
        raise RuntimeError(f"sharded {model}: no interior tiles")
    return {"losses": r["losses"], "val_accs": r["val_accs"],
            "train_time": r["train_time"], "launches": _counts(),
            "seconds": time.time() - t0}


BF16_HALO = ["--halo-dtype", "bfloat16"]


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp(min=1e-30))


def _step_grads(torch, ds, sg, mesh, n_hidden):
    """The summed gradients of one sharded SAGE step (2 hidden layers,
    dropout 0, the CLI's seeded init) over the mesh's graph dim, on this
    rank's rows of ``ds``: one flat host vector."""
    import numpy as np

    from gist_tpu_torch.models import sage
    from gist_tpu_torch.parallel import comm
    from gist_tpu_torch.parallel.graph_shard import shard_features, shard_rows
    from gist_tpu_torch.parallel.train import build_sharded_step
    rank, dev, n = mesh.get_local_rank("graph"), comm.mesh_device(mesh), \
        sg.n_loc_pad
    cfg = sage.SAGEConfig(ds.in_feats, n_hidden, ds.n_classes, n_layers=2,
                          dropout=0.0)
    p = sage.init(torch.Generator().manual_seed(3), cfg)
    p = {"layers": [{k: v.to(dev) for k, v in l.items()}
                    for l in p["layers"]]}

    def rows(a):
        return torch.from_numpy(shard_rows(sg, a)[rank * n:(rank + 1) * n]) \
            .to(dev)
    init_opt, step = build_sharded_step(sg, mesh, kind="sage", lr=1e-2,
                                        weight_decay=0.0)
    step(p, init_opt(p), shard_features(sg, ds.features, rank, dev),
         rows(ds.labels.astype(np.int32)), rows(ds.train_mask))
    return torch.cat([t.grad.reshape(-1) for l in p["layers"]
                      for t in l.values()]).cpu()


def _sharded_graph_ranks(torch, rank, world):
    """Phase 27's work on each rank: the sharded aggregation of
    synth-reddit-small at F=602 (forward, and the gradient of
    ``sum(y * w)``), K1 counted; the bf16 halo against its rounding
    bound; the sharded GAT attention (H=2, O=512) through K4 and the
    hybrid merge against the segment path; one sharded SAGE h256 step's
    gradients; rank 0 holds K1 against its plain walk on its interior
    layout; then the three sharded CLI runs."""
    import numpy as np

    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.parallel import (build_sharded_graph, comm,
                                         sharded_aggregate,
                                         sharded_gat_attention)
    from gist_tpu_torch.parallel.graph_shard import (gather_unshard,
                                                     shard_features,
                                                     shard_rows)
    from gist_tpu_torch.parallel.train import device_arrays

    out = {}
    ds = load_dataset("synth-reddit-small")
    mesh = comm.make_mesh("cuda", (world,), ("graph",))
    group = mesh.get_group("graph")
    t0 = time.time()
    sg = build_sharded_graph(ds.senders, ds.receivers, ds.n_nodes, world)
    out["graph_build_s"] = time.time() - t0
    if sg.int_dedup is None:
        raise RuntimeError("the sharded graph carries no interior tiles")
    n = sg.n_loc_pad
    rng = np.random.default_rng(0)
    w_np = rng.standard_normal(ds.features.shape).astype(np.float32)
    dev = comm.mesh_device(mesh)
    x = shard_features(sg, ds.features, rank, dev).requires_grad_(True)
    w = torch.from_numpy(shard_rows(sg, w_np)[rank * n:(rank + 1) * n]).to(
        dev)
    agg = sharded_aggregate(sg, mesh)
    _reset_counts()
    y = agg(x)
    (y * w).sum().backward()
    torch.cuda.synchronize()
    out["agg_launches"] = _counts()
    y_full = gather_unshard(sg, y.detach(), group)
    dx_full = gather_unshard(sg, x.grad, group)
    out.update(n_loc_pad=n, ring_shifts=list(sg.ring_shifts),
               ring_pads=list(sg.ring_pads), comm=sg.comm_stats(f=602))
    if rank == 0:
        from gist_tpu_torch.graph import graph_from_edges
        from gist_tpu_torch.ops.spmm import aggregate
        g = graph_from_edges(ds.senders, ds.receivers, ds.n_nodes).to(dev)
        xf = torch.from_numpy(ds.features).to(dev)
        out["fwd_rel_err"] = _rel(y_full, aggregate(g, xf,
                                                    backend="segment"))
        out["grad_rel_err"] = _rel(dx_full, aggregate(
            g.transpose(), torch.from_numpy(w_np).to(dev),
            backend="segment"))
        del g, xf
    with torch.no_grad():
        y16 = sharded_aggregate(sg, mesh, halo_dtype=torch.bfloat16)(x)
        bound = agg(x.abs()) * 2.0 ** -8 + 1e-6
        y32 = agg(x)
    out["bf16_within_rounding"] = bool(((y16 - y32).abs() <= bound).all())
    out["bf16_max_over_bound"] = float(((y16 - y32).abs() / bound).max())

    # the sharded GAT attention: K4's partial softmax merged with the
    # boundary partials, against the segment path on the same halo
    da = device_arrays(sg, mesh)
    g_rng = torch.Generator(device=dev).manual_seed(1 + rank)
    z = torch.randn((n, 2, 512), generator=g_rng, device=dev)
    src, dst = (torch.randn((n, 2), generator=g_rng, device=dev)
                for _ in range(2))
    with torch.no_grad():
        _reset_counts()
        att = sharded_gat_attention(sg, z, src, dst, da)
        out["gat_k4_launches"] = _counts()["K4"]
        seg_dev = {k: v for k, v in da.items() if k != "int_dedup"}
        ref = sharded_gat_attention(sg, z, src, dst, seg_dev)
    out["gat_hybrid_rel_err"] = _rel(att, ref)
    del z, src, dst, att, ref
    out["grads_h256"] = _step_grads(torch, ds, sg, mesh, 256)

    if rank == 0:
        xi = x.detach().contiguous()
        rows = {}
        for direction, t in (("fwd", da["int_dedup"]),
                             ("bwd", da["int_dedup_t"])):
            def kernel():
                return K.dedup_spmm(t.job_offsets, t.w_blocks, t.u_senders,
                                    xi)

            def plain():
                return K.dedup_spmm_reference(t.job_offsets, t.w_blocks,
                                              t.u_senders, xi)
            got, want = kernel(), plain()
            abs_err = float((got - want).abs().max())
            bound_ms, bound_by, _, _ = _k1_bound(torch, t, xi, got.shape[0])
            rows[f"interior {direction} F=602 float32"] = {
                "case": f"interior {direction} F=602 float32",
                "max_abs_err": abs_err,
                "rel_err": abs_err / float(want.abs().max()),
                "ms": _kernel_ms(torch, kernel),
                "plain_ms": _call_ms(torch, plain, reps=2),
                "bound_ms": bound_ms, "bound_by": bound_by}
        out["k1_interior"] = rows
    del x, w, y, y_full, dx_full, da
    torch.cuda.empty_cache()
    out["cli"] = {m: _sharded_cli(torch, m) for m in SHARDED_CLI}
    # the control of the CLI bars: a bf16 halo, a real loss of precision
    # on the wire, must read over them
    out["cli_gcn_bf16"] = _sharded_cli(torch, "gcn", BF16_HALO)
    return out


def _sharded_d1_in_parent(torch):
    """Phase 27's one-rank part, in this process on a one-rank nccl
    group: the card's time of the sharded aggregation at D=1 against
    the flat K1 aggregation of the same graph (F=602, forward), one
    sharded SAGE step's gradients at h256 and h128, and the three
    sharded CLI runs at D=1."""
    import tempfile

    import torch.distributed as dist

    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.ops.spmm import aggregate
    from gist_tpu_torch.parallel import (build_sharded_graph, comm,
                                         sharded_aggregate)
    from gist_tpu_torch.parallel.graph_shard import shard_features

    work = tempfile.mkdtemp(prefix="chip_smoke_d1_")
    dist.init_process_group("nccl", init_method=f"file://{work}/rdv",
                            rank=0, world_size=1)
    try:
        ds = load_dataset("synth-reddit-small")
        dev = torch.device("cuda")
        mesh = comm.make_mesh("cuda", (1,), ("graph",))
        t0 = time.time()
        sg = build_sharded_graph(ds.senders, ds.receivers, ds.n_nodes, 1)
        t = {"graph_build_s": time.time() - t0}
        if sg.int_dedup is None:
            raise RuntimeError("the D=1 sharded graph carries no tiles")
        t0 = time.time()
        g = graph_from_edges(ds.senders, ds.receivers, ds.n_nodes,
                             tiles=True).to(dev)
        t["flat_graph_build_s"] = time.time() - t0
        x_sh = shard_features(sg, ds.features, 0, dev)
        x = torch.from_numpy(ds.features).to(dev)
        agg = sharded_aggregate(sg, mesh)
        with torch.no_grad():
            t["d1_vs_flat_rel_err"] = _rel(agg(x_sh).index_select(
                0, sg.node_perm.to(dev).long()), aggregate(g, x))
            t["sharded_d1_ms"] = _kernel_ms(torch, lambda: agg(x_sh))
            t["flat_ms"] = _kernel_ms(torch, lambda: aggregate(g, x))
        t["ratio_sharded_over_flat"] = t["sharded_d1_ms"] / t["flat_ms"]
        del g, x, x_sh
        grads = {h: _step_grads(torch, ds, sg, mesh, h) for h in (256, 128)}
        torch.cuda.empty_cache()
        cli = {m: _sharded_cli(torch, m) for m in SHARDED_CLI}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    return t, grads, cli


def _grad_rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


# Phase 28's trainers: (model, config, TrainConfig, trainer keywords) of
# the SAGE h256 K=2 and GAT h512 K=2 cluster runs (the reddit-ist and
# reddit-gat widths on synth-reddit-small, psize 10, batch 4: every batch
# over TILES_MIN_EDGES) and the ultra-wide main path (SAGE h2048, 4
# hidden layers, K=8, synth-amazon2m-small, psize 50, batch 10), with
# the launches of one subnet's step.
def _ist_mesh_runs():
    from gist_tpu_torch.models import gat, sage
    from gist_tpu_torch.train.common import TrainConfig
    return {
        "cluster_sage": ("cluster", sage, "sage",
                         sage.SAGEConfig(602, 256, 41, n_layers=2,
                                         dropout=0.2),
                         TrainConfig(lr=3e-2, weight_decay=0.0, n_epochs=4,
                                     num_subnet=2, iter_per_site=2),
                         dict(psize=10, batch_size=4), {"K1": 5}),
        "cluster_gat": ("cluster", gat, "gat",
                        gat.GATConfig(602, 512, 41, n_layers=2, n_heads=2),
                        TrainConfig(lr=1e-2, weight_decay=5e-4, n_epochs=8,
                                    num_subnet=2, iter_per_site=4),
                        dict(psize=10, batch_size=4, normalize=True),
                        {"K4": 2, "K5": 3, "K6": 3}),
        "ultrawide": ("ultrawide", sage, "sage",
                      sage.SAGEConfig(100, 2048, 47, n_layers=4,
                                      dropout=0.2),
                      TrainConfig(lr=1e-2, weight_decay=0.0, n_epochs=8,
                                  num_subnet=8, iter_per_site=5),
                      dict(psize=50, batch_size=10, normalize=True,
                           use_f1=True, eval_on_cpu=False), {"K1": 9}),
    }


def _ist_run(torch, name, cache_dir, mesh=None):
    """One of phase 28's trainings, on a subnet mesh or (``mesh`` None)
    as the single-card loop: (result, launches, seconds)."""
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.train.ist_cluster import train_ist_cluster
    from gist_tpu_torch.train.ist_ultrawide import train_ist_ultrawide
    trainer, model, kind, cfg, tc, kw, _ = _ist_mesh_runs()[name]
    ds = load_dataset("synth-reddit-small" if trainer == "cluster"
                      else "synth-amazon2m-small")
    _reset_counts()
    t0 = time.time()
    if trainer == "cluster":
        r = train_ist_cluster(ds, cfg, tc, model=model, kind=kind,
                              mesh=mesh, cache_dir=cache_dir,
                              verbose=False, device="cuda", **kw)
    else:
        r = train_ist_ultrawide(ds, cfg, tc, model=model, kind=kind,
                                mesh=mesh, sequential=mesh is None,
                                cache_dir=cache_dir, verbose=False,
                                device="cuda", **kw)
    torch.cuda.synchronize()
    keep = ("losses", "val_accs", "test_accs", "round_wall_s",
            "edges_per_batch", "train_time")
    return {k: r[k] for k in keep}, _counts(), time.time() - t0


def _job_ist_mesh(torch, rank, world, names, cache_dir):
    """Phase 28's mesh runs ``names`` on a subnet mesh of all ranks."""
    from gist_tpu_torch.ist.distributed import make_subnet_mesh
    mesh = make_subnet_mesh(world, "cuda")
    return {n: _ist_run(torch, n, cache_dir, mesh) for n in names}


# Phase 29: cli.sharded_train --ist-subnets 2 at benchmarks/
# ist_sharded_2d.py's configuration (SAGE h128, 2 layers, lr 1e-2,
# synth-reddit-small), 2 rounds of 8 steps; the graph dim cut from 4 to
# 2 (4 ranks on the card).  K1 per rank: 5 a step (3 forward, 2
# transpose); the eval runs the flat graph's segment path.
IST_2D_ROUNDS, IST_2D_STEPS = 2, 8


def _ist_2d_cli(torch, world, extra=()):
    from gist_tpu_torch.cli import sharded_train
    _reset_counts()
    t0 = time.time()
    r = sharded_train.main([
        "--dataset", "synth-reddit-small", "--model", "sage",
        "--n-hidden", "128", "--n-layers", "2", "--dropout", "0",
        "--lr", "1e-2", "--ist-subnets", "2", "--n-devices", str(world),
        "--n-epochs", str(IST_2D_ROUNDS),
        "--iter_per_site", str(IST_2D_STEPS)] + list(extra))
    torch.cuda.synchronize()
    if not r["interior_tiles"]:
        raise RuntimeError("2-D mesh: no interior tiles")
    return {"losses": r["losses"], "val_accs": r["val_accs"],
            "mesh_2d": r["mesh_2d"], "train_time": r["train_time"],
            "launches": _counts(), "seconds": time.time() - t0}


def _job_ist_2d(torch, rank, world):
    """Phase 29 on S=2 x G=world/2 ranks: the CLI, the witnesses of its
    bar (the same run again, and a bf16-halo control), then one sharded
    SAGE h128 step's gradients over the 2-D mesh's graph dim."""
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.parallel import build_sharded_graph
    from gist_tpu_torch.parallel.ist_sharded import make_ist_graph_mesh
    out = _ist_2d_cli(torch, world)
    out["repeat"] = _ist_2d_cli(torch, world)
    out["bf16"] = _ist_2d_cli(torch, world, BF16_HALO)
    ds = load_dataset("synth-reddit-small")
    mesh = make_ist_graph_mesh(2, world // 2, "cuda")
    sg = build_sharded_graph(ds.senders, ds.receivers, ds.n_nodes,
                             world // 2)
    out["grads_h128"] = _step_grads(torch, ds, sg, mesh, 128)
    return out


def _job_pair(torch, rank, world, cache_dir):
    """The two-rank world: phase 27's ranks, phase 28's cluster-trainer
    mesh runs and phase 29's S=2 x G=1 reference, in turn."""
    from gist_tpu_torch.ist.distributed import make_subnet_mesh
    out = {"sharded_graph": _sharded_graph_ranks(torch, rank, world)}
    mesh = make_subnet_mesh(world, "cuda")
    out["ist_mesh"] = {n: _ist_run(torch, n, cache_dir, mesh)
                       for n in ("cluster_sage", "cluster_gat")}
    out["ist_2d_ref"] = _ist_2d_cli(torch, world)
    return out


def _check_sharded_graph(ranks, d1_times, d1_grads, d1_cli):
    """Phase 27's bars; returns its launches by kernel (every rank, the
    one-rank runs included)."""
    r0 = ranks[0]
    for r in ranks:
        if r["agg_launches"]["K1"] != 2:
            raise RuntimeError(f"K1 launched {r['agg_launches']} times in "
                               f"one sharded aggregation and its gradient, "
                               f"want 1 forward and 1 transpose a rank")
        if not r["bf16_within_rounding"]:
            raise RuntimeError("the bf16 halo is off by more than bf16 "
                               "rounding of the rows that crossed")
        if r["gat_k4_launches"] != 1 or not r["gat_hybrid_rel_err"] <= 1e-5:
            raise RuntimeError(f"sharded GAT through K4: "
                               f"{r['gat_k4_launches']} launches, rel err "
                               f"{r['gat_hybrid_rel_err']} (bar 1e-5)")
        if not _grad_rel(r["grads_h256"], d1_grads[256]) <= 1e-5:
            raise RuntimeError("sharded SAGE step: D=2 gradients off D=1's")
    if not (r0["fwd_rel_err"] <= 1e-5 and r0["grad_rel_err"] <= 1e-5):
        raise RuntimeError(f"sharded aggregation off the flat one: "
                           f"{r0['fwd_rel_err']}, {r0['grad_rel_err']}")
    if not d1_times["d1_vs_flat_rel_err"] <= 1e-5:
        raise RuntimeError("the D=1 sharded aggregation is off the flat one")
    for row in r0["k1_interior"].values():
        if not row["rel_err"] <= 1e-5:
            raise RuntimeError(f"K1 on the interior layout disagrees with "
                               f"its plain walk: {row}")
    launches = {
        "K1": sum(r["agg_launches"]["K1"] for r in ranks)
        + sum(c["launches"]["K1"] for c in d1_cli.values()),
        "K4": sum(r["gat_k4_launches"] for r in ranks)
        + sum(c["launches"]["K4"] for c in d1_cli.values())}
    for m, (_, want) in SHARDED_CLI.items():
        ref = d1_cli[m]["losses"]
        for name, got in [(m, r["cli"][m]) for r in ranks]:
            if len(got["losses"]) != SHARDED_EPOCHS or not _finite(
                    got["losses"]):
                raise RuntimeError(f"sharded {name}: bad losses {got}")
            tols = SHARDED_CLI_BARS[m]
            if not all(e <= tol for e, tol in
                       zip(_loss_rel(got["losses"], ref), tols)):
                raise RuntimeError(f"sharded {name} D=2 losses "
                                   f"{got['losses']} off D=1 {ref} (bars "
                                   f"{tols})")
            for k, per_epoch in want.items():
                if got["launches"][k] != per_epoch * SHARDED_EPOCHS:
                    raise RuntimeError(f"sharded {m}: {k} launched "
                                       f"{got['launches']}, want "
                                       f"{per_epoch} an epoch")
                launches[k] += got["launches"][k]
        for k, per_epoch in want.items():
            if d1_cli[m]["launches"][k] != per_epoch * SHARDED_EPOCHS:
                raise RuntimeError(f"sharded {m} at D=1: {k} launched "
                                   f"{d1_cli[m]['launches']}")
    for r in ranks:
        got = r["cli_gcn_bf16"]
        if got["launches"]["K1"] != SHARDED_CLI["gcn"][1]["K1"] \
                * SHARDED_EPOCHS or not _finite(got["losses"]):
            raise RuntimeError(f"sharded gcn, bf16 halo: {got}")
        if not any(e > tol for e, tol in zip(
                _loss_rel(got["losses"], d1_cli["gcn"]["losses"]),
                SHARDED_CLI_BARS["gcn"])):
            raise RuntimeError(f"the CLI bars do not tell a bf16 halo apart:"
                               f" {got['losses']} against D=1's "
                               f"{d1_cli['gcn']['losses']}")
        launches["K1"] += got["launches"]["K1"]
    return launches


def _check_ist_mesh(name, ranks, loop):
    """Phase 28's bars for one run; returns its launches (every rank)."""
    from gist_tpu_torch.sampler import TILES_MIN_EDGES
    _, _, _, _, tc, _, per_step = _ist_mesh_runs()[name]
    res0 = ranks[0][0]
    steps = len(res0["losses"]) * tc.iter_per_site
    if not all(e >= TILES_MIN_EDGES for e in res0["edges_per_batch"]):
        raise RuntimeError(f"{name}: a batch fell under the layout's edge "
                           f"threshold")
    total = dict.fromkeys(("K1", "K4", "K5", "K6"), 0)
    for res, launches, _ in ranks:
        if res["losses"] != res0["losses"] or \
                res["val_accs"] != res0["val_accs"]:
            raise RuntimeError(f"{name}: ranks return other results")
        for k, n in per_step.items():
            if launches[k] != n * steps:
                raise RuntimeError(f"{name}: {k} launched {launches} on a "
                                   f"rank, want {n} a step")
            total[k] += launches[k]
    for a, b in zip(res0["losses"] + res0["val_accs"],
                    loop["losses"] + loop["val_accs"]):
        if not abs(a - b) <= 1e-5 * abs(b):
            raise RuntimeError(f"{name}: mesh {res0['losses']} "
                               f"{res0['val_accs']} off the loop's "
                               f"{loop['losses']} {loop['val_accs']}")
    if not _finite(res0["losses"] + res0["val_accs"]):
        raise RuntimeError(f"{name}: non-finite loss or accuracy")
    return total


def phase_multi_rank(torch, power):
    """Phases 27-29, ranks on the one card.  The one-rank and
    single-card references run first in this process, then three worlds
    of spawned ranks: two (phase 27's ranks, phase 28's cluster-trainer
    meshes, phase 29's S=2 x G=1 reference), eight (phase 28's
    ultra-wide mesh) and four (phase 29's 2 x 2 mesh).  Returns the
    launches by phase and kernel, and K1's interior rows."""
    import tempfile
    t_ref = time.time()
    d1_times, d1_grads, d1_cli = _sharded_d1_in_parent(torch)
    d1_s = time.time() - t_ref
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_parts_")
    loops = {name: _ist_run(torch, name, cache_dir)
             for name in _ist_mesh_runs()}
    ref_s = time.time() - t_ref
    pair_backend, pair, pair_s = _spawn(torch, 2, "_job_pair",
                                        cache_dir=cache_dir)
    uw_backend, uw, uw_s = _spawn(torch, 8, "_job_ist_mesh",
                                  names=["ultrawide"], cache_dir=cache_dir)
    b4, r4, s4 = _spawn(torch, 4, "_job_ist_2d")
    shutil.rmtree(cache_dir, ignore_errors=True)
    emit({"phase": "multi_rank_worlds", "references_s": ref_s,
          "world2_s": pair_s, "world8_s": uw_s, "world4_s": s4})

    sg_ranks = [r["sharded_graph"] for r in pair]
    r0 = sg_ranks[0]
    emit({"phase": "sharded_graph", "part": "one_rank", "backend": "nccl",
          "world": 1, "card": power, "seconds": d1_s, **d1_times,
          "cli_losses": {m: c["losses"] for m, c in d1_cli.items()},
          "cli_seconds": {m: c["seconds"] for m, c in d1_cli.items()},
          "cli_launches": {m: c["launches"] for m, c in d1_cli.items()}})
    emit({"phase": "sharded_graph", "part": "two_ranks",
          "backend": pair_backend, "world": 2,
          "graph_build_s": [r["graph_build_s"] for r in sg_ranks],
          "n_loc_pad": r0["n_loc_pad"], "ring_shifts": r0["ring_shifts"],
          "ring_pads": r0["ring_pads"], "comm_f602": r0["comm"],
          "agg_launches": [r["agg_launches"] for r in sg_ranks],
          "fwd_rel_err": r0["fwd_rel_err"],
          "grad_rel_err": r0["grad_rel_err"],
          "bf16_max_over_bound": [r["bf16_max_over_bound"]
                                  for r in sg_ranks],
          "gat_hybrid_rel_err": [r["gat_hybrid_rel_err"] for r in sg_ranks],
          "gat_k4_launches": [r["gat_k4_launches"] for r in sg_ranks],
          "step_grad_rel_err_vs_d1": [_grad_rel(r["grads_h256"],
                                                d1_grads[256])
                                      for r in sg_ranks],
          "k1_interior": r0["k1_interior"],
          "cli": {m: {"losses": r0["cli"][m]["losses"],
                      "val_accs": r0["cli"][m]["val_accs"],
                      "seconds": r0["cli"][m]["seconds"],
                      "rel_vs_d1": _loss_rel(r0["cli"][m]["losses"],
                                             d1_cli[m]["losses"]),
                      "bars": SHARDED_CLI_BARS[m],
                      "launches": [r["cli"][m]["launches"]
                                   for r in sg_ranks]}
                  for m in SHARDED_CLI},
          "gcn_bf16_control": {
              "rel_vs_d1": _loss_rel(r0["cli_gcn_bf16"]["losses"],
                                     d1_cli["gcn"]["losses"]),
              "seconds": r0["cli_gcn_bf16"]["seconds"]}})

    meshes = {n: (pair_backend, 2, [r["ist_mesh"][n] for r in pair])
              for n in ("cluster_sage", "cluster_gat")}
    meshes["ultrawide"] = (uw_backend, 8, [r["ultrawide"] for r in uw])
    for name, (backend, world, ranks) in meshes.items():
        loop, loop_launches, loop_s = loops[name]
        res0 = ranks[0][0]
        emit({"phase": "ist_mesh", "run": name, "backend": backend,
              "world": world, "rank_seconds": [r[2] for r in ranks],
              "loop_seconds": loop_s, "losses": res0["losses"],
              "loop_losses": loop["losses"], "val_accs": res0["val_accs"],
              "loop_val_accs": loop["val_accs"],
              "round_wall_s": res0["round_wall_s"],
              "loop_round_wall_s": loop["round_wall_s"],
              "launches_per_rank": [r[1] for r in ranks],
              "loop_launches": loop_launches})

    ref2 = [r["ist_2d_ref"] for r in pair]
    emit({"phase": "ist_sharded_2d", "backend": b4, "world": 4,
          "mesh_2d": r4[0]["mesh_2d"], "cut": "graph dim 4 -> 2",
          "seconds": [r["seconds"] for r in r4],
          "losses": r4[0]["losses"], "val_accs": r4[0]["val_accs"],
          "train_time": r4[0]["train_time"],
          "launches_per_rank": [r["launches"] for r in r4],
          "step_grad_rel_err_vs_d1": [_grad_rel(r["grads_h128"],
                                                d1_grads[128]) for r in r4],
          "rel_vs_g1": _loss_rel(r4[0]["losses"], ref2[0]["losses"]),
          "bars": IST_2D_BARS,
          "witness": {
              "repeat_vs_g1": _loss_rel(r4[0]["repeat"]["losses"],
                                        ref2[0]["losses"]),
              "repeat_vs_first": _loss_rel(r4[0]["repeat"]["losses"],
                                           r4[0]["losses"]),
              "bf16_vs_g1": _loss_rel(r4[0]["bf16"]["losses"],
                                      ref2[0]["losses"]),
              "seconds": [r4[0]["repeat"]["seconds"],
                          r4[0]["bf16"]["seconds"]]},
          "reference": {"backend": pair_backend, "world": 2,
                        "mesh_2d": ref2[0]["mesh_2d"],
                        "seconds": [r["seconds"] for r in ref2],
                        "losses": ref2[0]["losses"],
                        "val_accs": ref2[0]["val_accs"],
                        "train_time": ref2[0]["train_time"]}})

    # every line is out before the first check can raise
    launches = {"sharded_graph": _check_sharded_graph(sg_ranks, d1_times,
                                                      d1_grads, d1_cli),
                "ist_mesh": dict.fromkeys(("K1", "K4", "K5", "K6"), 0)}
    for name, (_, _, ranks) in meshes.items():
        for k, v in _check_ist_mesh(name, ranks, loops[name][0]).items():
            launches["ist_mesh"][k] += v
    want = 5 * IST_2D_ROUNDS * IST_2D_STEPS
    runs_2d = ref2 + [x for r in r4 for x in (r, r["repeat"], r["bf16"])]
    for r in runs_2d:
        if r["launches"]["K1"] != want:
            raise RuntimeError(f"2-D mesh: K1 launched {r['launches']} on a "
                               f"rank, want {want}")
    for key in (None, "repeat", "bf16"):
        got = [r if key is None else r[key] for r in r4]
        if any(g["losses"] != got[0]["losses"] for g in got):
            raise RuntimeError("2-D mesh: ranks return other losses")
    for r in r4:
        if not _grad_rel(r["grads_h128"], d1_grads[128]) <= 1e-5:
            raise RuntimeError("2-D mesh: a graph row's step gradients are "
                               "off the one-rank step's")
    # a round's loss is the mean over 8 Adam steps: the first is the
    # initial params' forward, the later ones carry Adam's amplification
    # of last-bit gradient differences (see SHARDED_CLI_BARS)
    for key in (None, "repeat"):
        got = r4[0]["losses"] if key is None else r4[0][key]["losses"]
        if not _finite(got) or not all(
                e <= tol for e, tol in
                zip(_loss_rel(got, ref2[0]["losses"]), IST_2D_BARS)):
            raise RuntimeError(f"2-D mesh losses {got} off the S=2 x G=1 "
                               f"run's {ref2[0]['losses']} (bars "
                               f"{IST_2D_BARS})")
    if not _loss_rel(r4[0]["bf16"]["losses"][:1],
                     ref2[0]["losses"][:1])[0] > IST_2D_BARS[0]:
        raise RuntimeError(f"the 2-D round-1 bar does not tell a bf16 halo "
                           f"apart: {r4[0]['bf16']['losses']} against "
                           f"{ref2[0]['losses']}")
    launches["ist_sharded_2d"] = {
        "K1": sum(r["launches"]["K1"] for r in runs_2d)}
    return launches, r0["k1_interior"]


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
    pp_launches = phase_cluster_pp(torch, ds)
    emit({"phase": "cluster_pp", "seconds": time.time() - t0})

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

    t0 = time.time()
    phase_ist_simulation(torch)
    emit({"phase": "ist_simulation", "seconds": time.time() - t0})

    t0 = time.time()
    lsgd_launches, lsgd_k1 = phase_lsgd(torch, device, gat_sampler)
    emit({"phase": "lsgd", "seconds": time.time() - t0})

    t0 = time.time()
    ic_gcn_launches, uw_gcn_launches, gcn_k1 = phase_ist_gcn(
        torch, device, dataclasses.replace(ds_r), ds, gat_sampler, sampler)
    emit({"phase": "ist_gcn", "seconds": time.time() - t0})
    del gat_sampler

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

    # the phases that replay CUDA graphs come after every phase that
    # reads kernel times from a torch.profiler trace: once graphs had
    # run, later traces were seen to miss kernel events
    t0 = time.time()
    scan_b_launches, scan_b_rows = phase_scan_batches(torch, ds, sampler)
    emit({"phase": "scan_batches", "seconds": time.time() - t0})
    del sampler

    t0 = time.time()
    phase_sweep(torch)
    emit({"phase": "sweep", "seconds": time.time() - t0})

    t0 = time.time()
    scan_v1_launches, scan_v1_rows = phase_scan_epochs_v1(
        torch, device, dataclasses.replace(ds_r), v1_graph)
    emit({"phase": "scan_epochs_v1", "seconds": time.time() - t0})
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

    t0 = time.time()
    scan_c_launches, scan_c_row = phase_scan_epochs_chunked(
        torch, device, ds_big, big_graph)
    emit({"phase": "scan_epochs_chunked", "seconds": time.time() - t0})
    del ds_big, big_graph
    torch.cuda.empty_cache()

    t0 = time.time()
    multi, k1_interior = phase_multi_rank(torch, dev["power"])
    emit({"phase": "multi_rank", "seconds": time.time() - t0})
    sharded_launches, mesh_launches = multi["sharded_graph"], \
        multi["ist_mesh"]
    ist_2d_launches = multi["ist_sharded_2d"]["K1"]

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
        + cli_launches + pp_launches + lsgd_launches + ic_gcn_launches
        + uw_gcn_launches + scan_b_launches + scan_c_launches
        + sharded_launches["K1"] + mesh_launches["K1"] + ist_2d_launches,
        "launches_by_path": {"sage_ultrawide": launches,
                             "full_graph_gcn": full_launches,
                             "uw_resume": resume_launches,
                             "uw_cli_synth_reddit": cli_launches,
                             "cluster_pp": pp_launches,
                             "ist_simulation": 0,
                             "lsgd": lsgd_launches,
                             "ist_cluster_gcn": ic_gcn_launches,
                             "ultrawide_gcn": uw_gcn_launches,
                             "scan_batches": scan_b_launches,
                             "scan_epochs_chunked_gcn": scan_c_launches,
                             "sharded_graph": sharded_launches["K1"],
                             "ist_mesh": mesh_launches["K1"],
                             "ist_sharded_2d": ist_2d_launches},
        "replay_rel_err": max([r["rel_err"] for r in scan_b_rows.values()]
                              + [scan_c_row["rel_err"]]),
        "max_abs_err": max([c["max_abs_err"] for c in [
            *cases.values(), *chunked_rows.values(), *lsgd_k1.values(),
            *gcn_k1.values()] if c["case"].endswith("float32")]
            + [r["max_abs_err"] for r in k1_interior.values()]),
        "sharded_interior": k1_interior,
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
        sharded = sharded_launches["K4"] if key == "K4" else 0
        kernels.append({
            "name": name, "route": "cuda",
            "source": "gist_tpu_torch/csrc/gat_dedup.cu",
            "replaces": replaces,
            "launches": count + extra + sharded + mesh_launches[key],
            "launches_by_path": {"gat_gist": count,
                                 "gat_gist_mesh": mesh_launches[key],
                                 **({"full_graph_gat": extra,
                                     "sharded_gat": sharded}
                                    if key == "K4" else {})},
            "max_abs_err": max(r["max_abs_err"] for (k, tag), r in
                               gat_rows.items()
                               if k == key and tag.endswith("float32")),
            "ms": main_row["ms"], "call_ms": main_row["call_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "segment_ms": main_row["segment_ms"],
            **{k: main_row[k] for k in ("dz_library_ms", "profiler_ms",
                                        "bitwise_repeat")
               if main_row.get(k) is not None}})
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
        scan_path, replay_key = ("scan_epochs_v1_gcn", "K3") \
            if key == "K3" else ("scan_epochs_v1_gat", "K7-K9")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"gist_tpu_torch/csrc/{source}",
            "replaces": f"gist_tpu/ops/{replaces}",
            "launches": v1_launches[key] + scan_v1_launches[key],
            "launches_by_path": {path: v1_launches[key],
                                 scan_path: scan_v1_launches[key]},
            "replay_rel_err": max(r["rel_err"] for (k, _), r in
                                  scan_v1_rows.items() if k == replay_key),
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
