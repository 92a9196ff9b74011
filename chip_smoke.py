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
    with times (the plain walk timed once, as it is checked);
11. split path: one GCN h256 training step through K2 on the split
    layouts and through K1 per chunk on the chunked layouts of the same
    graph must agree, counting K2 launches;
12. full-scale main path: ``train_full_graph``, GCN h256, 6 epochs on
    synth-reddit (46.8M edges with self loops) through the chunked
    layouts, counting K1 launches (4 C_f + 2 C_t per epoch); the dataset
    and its chunked pair are built on the host by a child process
    started after the build phase (``HostBuilds``), so the build runs
    beside the phases before this one; then K1 per
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
    a checkpoint each round, 2 rounds uninterrupted, then 1 round into
    a fresh directory resumed to 2 (3, 2 and 3 before, cut to keep the
    script's time); the resumed call returns the whole run, whose
    first round reads back as the cut run recorded it and whose losses
    and val F1 must equal the uninterrupted run's bit for bit, K1 9
    launches a step trained in every run;
18. uw_cli_chunked_eval (run last): ``python -m
    gist_tpu_torch.cli.ist_distrib --ultra-wide`` as a function, SAGE
    h2048, 1 hidden layer (4, then 2 before, cut to keep the script's
    time), K=8, 1 round of 10 steps a subnet on synth-reddit (psize 100,
    batch 10: K1 on every batch, 3 launches a step) with a checkpoint
    and the chunked host eval; then ``cli.infer`` on the last round on
    the card (its ``sage.apply`` timed: the card's eval wall), and the
    chunked host forward of the same params held against the card's
    logits at rtol = atol = 0.05, with both walls, the host's ``nproc``
    and torch threads.
19. cluster_pp (run after phase 6): ``train_cluster_gcn`` with SAGE
    h256, 2 layers on phase 6's clusters, once with ``use_pp`` (K1 4
    launches a step, the first layer skipping its aggregation) and once
    for 5 epochs on multi-hot labels (sigmoid BCE must fall; micro-F1
    must beat predicting every label positive), counting K1 launches;
20. ist_simulation: ``cli.train_ist`` as a function, GCN h256, 2
    layers, K=4 on synth-reddit-small (self loops, random projection),
    10 epochs, loop and ``--fused``: the loop's per-round mean losses
    equal the fused rounds' within 5e-7 relative, and K1 launches 0
    times (the full graph carries no layout: S1 carries it);
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
    h256, 2 layers, dropout 0 on phase 6's clusters for 2 epochs (3
    before, cut to keep the script's time), the
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
    on the one card, the two-rank world beside the four-rank one of
    phase 29; each prints its backend and world size): on two
    ranks (gloo: NCCL refuses two ranks on one device) the sharded
    aggregation of synth-reddit-small at F=602 against the flat one,
    forward and gradient (1e-5; K1 one forward and one transpose a rank),
    the bf16 halo within the rounding of the rows that crossed, the
    sharded GAT attention through K4 against the segment path (1e-5),
    one sharded SAGE step's gradients against one rank's (1e-5), K1
    against its plain walk on rank 0's interior layout, and
    ``cli.sharded_train`` for SAGE h256, GCN h256 and GAT h512 (2 heads),
    2 layers, 3 epochs, against the same CLI on one rank (nccl, in this
    process; 1e-5, GCN's first epoch exactly and its later ones 1e-4),
    with launches per rank, the GCN run repeated bit for bit, and a GCN
    run with a bf16 halo as the control that reads over those bars;
    on one rank also the sharded aggregation's time against the flat K1
    aggregation's; on each rank the bytes/s of a ring exchange of its
    F=602 halo rows (``bench/scaling_projection.py:ring_shift_rate``),
    the link these ranks use (gloo, staged through host memory), which
    phase 32 projects with;
28. ist_mesh: ``train_ist_cluster(mesh=...)`` (SAGE h256 and GAT h512,
    K=2, 2 ranks) and ``train_ist_ultrawide(sequential=False)`` (the
    main path's SAGE h2048 K=8, 8 ranks, 1 round) against their
    single-card loops: losses and accuracies within 1e-5, K1 and K4-K6
    per rank as derived;
29. ist_sharded_2d: ``cli.sharded_train --ist-subnets 2`` (SAGE h128,
    2 layers, 2 rounds of 8 steps) on a 2 x 2 mesh (4 ranks: the graph
    dim cut from 4 to 2) against S=2 x G=1 (2 ranks): K1 80 a rank, one
    step's gradients on the 2-D mesh's graph rows against one rank's
    (1e-5), the round-mean losses of the run within 4e-5 (round 1) and
    1e-3 (round 2: Adam's steps amplify the last bits of another order of
    summation), the same run repeated bit for bit, and a bf16-halo
    control that reads over round 1's bar.  Then, once,
    ``gist_tpu_torch/bench/ist_sharded_2d.py:run`` on the same 2 x 2
    mesh: its 2-D run (K1 80 a rank) against its 1-D control within the
    same bars, both curves printed, the graph columns' 1-D controls
    equal bit for bit.
30. bench (run right after the build phase): every launch count set to
    0, ``python3 bench_torch.py`` in a subprocess from the checkout's
    root (one JSON line: every JAX bench key but those not carried over,
    each number positive, ``hardware`` this card, K1's bound share at
    most 1; its launches come back in its line), the graft entry's
    forward (``graft_entry.entry()``, K1 on synth-tiny) and the scripts
    of ``gist_tpu_torch/bench/`` once each at their default sizes
    (``BENCH_SCRIPTS``; ``gat`` with ``--train-step`` on both layouts),
    their lines printed and checked: ``kernel_tune``'s K1 at TN 64, 128
    (the headline layout) and 256, fp32 and bf16, against its plain walk
    (1e-5, 1e-2) and bitwise over two launches; the GAT configurations'
    first-step gradients against the segment backend's.  K1 and K4-K9
    must all have launched.  Then, uncounted, the entry's other sections
    on its own inputs against their plain versions: the SAGE train
    step's first step through K1 against the segment path, K4 at D=128,
    K1 on the TN-64 chunked layout, and the graft entry's forward.

31. fullscale_scripts (run after phase 26, on its graph): the
    full-scale benchmark scripts of ``gist_tpu_torch/bench/`` called in
    this process at the JAX widths on graphs held here, their launches
    counted together: ``amazon_spmm`` on synth-amazon2m-small (F=100, TN
    64, 2^13 slots a chunk) at threshold 0 (K1 once per chunk) and 128
    (K2 once per chunk), each at CU 512 and 1024, against its plain walk
    and the segment path over the whole output (1e-5 each);
    ``gat_chunked`` on phase 12's synth-reddit graph (K4 once per chunk,
    D=128, 2 heads), its zero-score attention against K1 once per chunk
    times 1/in_deg (1e-5); ``uw_k1_probe`` at h2048 on
    synth-amazon2m-small (psize 50, batch 10), 3 rounds of 5 steps;
    ``amazon_uw_fullscale`` at h512, K=8 there: 1 round, then a rerun
    with the same key to 2, which must resume after round 1 (it trains
    round 2 only; round 1's loss and val F1 stay as the first call wrote
    them); ``cluster_fullscale`` for 1 epoch there (psize 50) against a
    direct ``train_cluster_gcn`` call with the same config and seed
    (losses 1e-5).  Those two evaluate on the card, not on the host as
    the scripts do at full length.  ``ist_sharded_2d`` runs through
    phase 29.
32. remaining_scripts (run after phases 27-29, on the graphs earlier
    phases hold): ``scaling_projection`` on synth-reddit-small at D = 2
    and 4, its t1 K1's forward measured here at fp32 and bf16, its link
    rate phase 27's measured ring rate (the slower rank's), named so;
    ``record_r2`` cut to its reddit-small full-graph SAGE fp32 run at 3
    of 60 epochs (K1; losses 1e-5 relative) and the ultra-wide point h64
    K=2 at one round (``R2_UW``; its batches under the threshold, so S1;
    losses bit for bit), each against its trainer called directly; both
    Amazon2M cost models on synth-amazon2m-small at TN 64, on the order
    of phase 31's v2 layout, with their gather and stream rates and
    permute time measured on the card in the phase.
33. segment_csr (run after phase 23): S1, the segment path's CSR row
    walk, against its plain version (gather and ``index_add_``: fp32
    1e-5, bf16 1e-2) and bitwise over two launches, with times beside its
    bound and three PyTorch yardsticks (``torch.sparse.mm`` over the CSR
    tensor, ``torch.segment_reduce`` over the gathered messages,
    ``index_add_`` under ``use_deterministic_algorithms(True)``), on a
    flagship-shaped batch (synth-amazon2m-small, psize 750, batch 10:
    F=256 and F=100 forward and transpose, fp32 and bf16, the GAT
    weighted sum at D=256 and 41 and the softmax denominators) and on
    synth-reddit-small (F=602 and F=256 forward and transpose); the
    audit's repeats, each run twice from one seed and
    held bit for bit in losses, accuracies and parameters: one round of
    the flagship-shaped path (SAGE h2048, 4 hidden layers, K=8, at the
    default threshold, so S1) and one GAT-GIST round (h512, 2 heads,
    K=2, synth-reddit-small psize 40, batch 4); the D=2 sharded GCN
    CLI's repeat is phase 27's; then a segment-path SAGE step captured
    and replayed (``scan_batches``), S1 in every replay's trace.  Its
    rows give each shape's plan, the rows' gather rate and, for the
    unweighted sums, ``torch.sparse.mm`` over the CSR tensor
    (``library_csr_ms``).
34. s1_plans (run just before phase 33, on its shapes, which add the
    flagship batch at F=100 bf16, every transpose, and the GAT weighted
    sum at D=41): every plan of S1's plan space held bit for bit against
    the chosen plan's output and timed, every plan once a round over
    three rounds (median), with the chosen and the fastest plan; then
    S1 at the flagship batch with every index set to row 0 and with no
    edges, beside its own time (where a batch's time goes).

The layouts of phases 10, 12 and 31, and phase 32's cost-model counts
and partitions, are built on the host by one child process started
after the build phase (``host_builds``, ``HostBuilds``), which saves
each to ``scratch_chip/`` as soon as it is built; each phase loads its
own, so those builds run beside the phases before them.

Every world of spawned ranks runs within ``SPAWN_TIMEOUT_S``: past it
every rank is ended with its process group and the phase raises
(``procs.join_spawned``); each rank's process group times out at three
quarters of it.

Replayed outputs are held against the plain versions at 1e-5 relative to
the plain result's max, after the outputs were overwritten with NaN.

Before the kernel summary line the script waits up to 10 s for every
process it started to end (``gist_tpu_torch/bench/procs.py:
descendants``), prints ``{"phase": "processes", "left": [...]}`` and
exits non-zero, after killing them, if any remains.  Every child goes
through ``procs.run_child``/``run_children``, which end its whole
process group; the ranks of phases 27-29 are spawned and joined by
``torch.multiprocessing``, and the ``spawn`` context's resource tracker,
which would otherwise live until this process exits, is stopped
explicitly before the check (``multiprocessing.resource_tracker``).

Kernel and library times: ``ms`` is device time per call, one CUDA
event pair around back-to-back calls queued ahead of the card
(``gist_tpu_torch/bench/timing.py:kernel_ms``); ``call_ms`` is one call
between two events, the wrapper's host work included (``call_ms``, the
figure of earlier runs).  Plain versions and model forwards keep
one-call timing.

Then the kernel summary line, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero without a card or
without the package beside it.
"""

import contextlib
import json
import os
import shutil
import statistics
import sys
import time

# the package beside this script; without it the script stops here
from gist_tpu_torch.bench import procs
from gist_tpu_torch.bench.common import (bound, chunked_bound, chunked_plain,
                                         k1_bound, launch_counts,
                                         reset_launch_counts)
from gist_tpu_torch.bench.timing import call_ms, kernel_ms

HERE = os.path.dirname(os.path.abspath(__file__))


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase_device(torch):
    out = procs.run_child(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], 60, capture_output=True, text=True,
        check=True)
    print(out.stdout.strip(), flush=True)
    return {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "power": out.stdout.strip()}


def phase_build():
    """One nvcc per kernel source, all started together; every one is
    waited for (``procs.run_children``) before the first failure
    raises."""
    from gist_tpu_torch.ops import (dedup_spmm, gat_dedup, gat_tiled,
                                    segment_csr, split_spmm, tiled_spmm)
    modules = [dedup_spmm, gat_dedup, split_spmm, tiled_spmm, gat_tiled,
               segment_csr]
    os.makedirs(dedup_spmm.BUILD_DIR, exist_ok=True)
    t0 = time.time()
    libs = [dedup_spmm.library_path(mod.SOURCE) for mod in modules]
    tmps = [f"{lib}.{os.getpid()}.tmp" for lib in libs]
    done = procs.run_children(
        [dedup_spmm.build_command(tmp, mod.SOURCE)
         for mod, tmp in zip(modules, tmps)], timeout=900,
        capture_output=True, text=True)
    for mod, lib, tmp, res in zip(modules, libs, tmps, done):
        if res.returncode:
            raise RuntimeError(f"nvcc failed for {mod.SOURCE}:\n{res.stderr}")
        os.replace(tmp, lib)
        entries = _ptxas_entries(res.stderr)
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
                    dtype = ("bf16" if "bfloat16" in args else
                             {"f": "f32", "d": "f64"}.get(args[:1]))
                    name = "{}<{}>".format(mangled[end - size:end], ",".join(
                        [dtype] * (dtype is not None)
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
            bound_ms, bound_by, nbytes, flops = k1_bound(lay, x,
                                                         got.shape[0])
            adj = _csr_adjacency(torch, g, dtype, device,
                                 transpose=direction == "bwd")
            try:
                library_call_ms = call_ms(
                    lambda: torch.sparse.mm(adj, x), reps=10)
            except RuntimeError as e:   # no such library call for dtype
                library_ms = library_call_ms = None
                lib_note = str(e).splitlines()[0]
            else:
                library_ms = kernel_ms(lambda: torch.sparse.mm(adj, x))
                lib_note = "torch.sparse.mm on a CSR adjacency"
            ms = kernel_ms(kernel)
            row = {"phase": phase, "case": f"{direction} F={f} "
                   f"{str(dtype).split('.')[-1]}",
                   "max_abs_err": abs_err, "rel_err": rel_err, "tol": tol,
                   "ms": ms, "call_ms": call_ms(kernel, reps=20),
                   "plain_ms": call_ms(plain, reps=3),
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


def _reversed_edges(g):
    """``g`` rebuilt (without layouts) from its edges in reverse order,
    so that the segment path sums each row's edges the other way round:
    the witness of summation-order noise."""
    from gist_tpu_torch.graph import graph_from_edges
    e = int(g.indptr[-1])
    s, r = (a[:e].cpu().numpy()[::-1] for a in (g.senders, g.receivers))
    return graph_from_edges(s, r, g.n_nodes, pad_to=g.n_edges_padded).to(
        g.senders.device)


def phase_reference(torch, device, sampler):
    """One flagship sub-model (width 256, four hidden layers, dropout 0)
    on real batches, through K1 and through the segment path (S1): the
    first step's parameter gradients and the losses of
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
    flipped = batches[0].replace(graph=_reversed_edges(batches[0].graph))
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
    each; 2 rounds uninterrupted, then 1 round into a fresh directory
    and that directory resumed to 2 (3, 2 and 3 before).  The resumed
    call returns the whole run: its first round must read back as the
    cut run recorded it, and the whole must equal the uninterrupted run
    bit for bit (K1 and S1, which the evals on the full graph run, sum
    in a fixed order); every run launches K1 9 times a step it
    trains."""
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
        last = latest_round_dir(ck)
        start = 0 if last is None else int(
            os.path.basename(last).split("_")[1]) + 1
        K.launches = 0
        t0 = time.time()
        r = train_ist_ultrawide(dataclasses.replace(ds), cfg, tc, psize=50,
                                batch_size=10, normalize=True, use_f1=True,
                                eval_on_cpu=False, checkpoint_dir=ck,
                                verbose=False, device="cuda")
        torch.cuda.synchronize()
        r["wall_s"] = time.time() - t0
        steps = (len(r["round_wall_s"]) - start) * tc.num_subnet \
            * tc.iter_per_site
        if K.launches != 9 * steps:
            raise RuntimeError(f"K1 launched {K.launches} times in "
                               f"{steps} steps, want 9 per step")
        launches += K.launches
        r["k1_launches"] = K.launches
        return r

    with tempfile.TemporaryDirectory() as tmp:
        full = run(16, os.path.join(tmp, "full"))
        ck = os.path.join(tmp, "cut")
        cut = run(8, ck)
        if os.path.basename(latest_round_dir(ck) or "") != "round_0":
            raise RuntimeError("the cut run left no round_0 checkpoint")
        resumed = run(16, ck)
    loss_diff = _rel_diff(resumed["losses"], full["losses"])
    f1_diff = _rel_diff(resumed["val_accs"], full["val_accs"])
    read_back = (resumed["losses"][:1] == cut["losses"]
                 and resumed["val_accs"][:1] == cut["val_accs"])
    row = {"phase": "uw_resume", "rounds": [len(full["losses"]),
                                            len(cut["losses"]),
                                            len(resumed["losses"])],
           "losses": full["losses"],
           "resumed_losses": resumed["losses"], "val_f1": full["val_accs"],
           "resumed_val_f1": resumed["val_accs"],
           "loss_rel_diff": loss_diff, "val_f1_rel_diff": f1_diff,
           "tol": "bitwise", "cut_round_read_back": read_back,
           "k1_launches": launches,
           "k1_launches_by_run": [full["k1_launches"], cut["k1_launches"],
                                  resumed["k1_launches"]],
           "wall_s": [full["wall_s"], cut["wall_s"], resumed["wall_s"]],
           "round_wall_s": full["round_wall_s"],
           "eval_wall_s": full["eval_wall_s"],
           "resumed_round_wall_s": resumed["round_wall_s"]}
    emit(row)
    if [len(full["losses"]), len(cut["losses"]),
            len(resumed["losses"])] != [2, 1, 2]:
        raise RuntimeError(f"expected 2, 1 and 2 rounds: {row['rounds']}")
    if not read_back:
        raise RuntimeError("the resumed run's record lost the cut run's "
                           "round")
    if not (resumed["losses"] == full["losses"]
            and resumed["val_accs"] == full["val_accs"]):
        raise RuntimeError("the resumed run left the uninterrupted one")
    if not all(v == v and abs(v) < float("inf")
               for v in full["losses"] + full["val_accs"]):
        raise RuntimeError("non-finite loss or F1")
    return launches


# Phase 18's depth: 1 hidden layer (4, then 2 before), which cuts its
# chunked host eval, the script's largest single cost.  10 steps a
# subnet: one local epoch of synth-reddit's 10 batches, so one round.
UW_CLI_LAYERS = 1
UW_CLI_STEPS = 10
# its partitions (psize 100, the CLI's seed 3) come from the host builds
UW_CLI_PSIZE, UW_CLI_SEED = 100, 3


def phase_uw_cli_chunked_eval(torch, device, builds):
    """The entry point and the serving path: ``cli.ist_distrib
    --ultra-wide`` trains SAGE h2048 (1 hidden layer, K=8) for 1 round
    on synth-reddit with a checkpoint; N x h is over the trainer's
    threshold, so each eval runs the chunked host forward (its output is
    kept as it returns).  Then ``cli.infer`` evaluates the last round on
    the card with the plain ``sage.apply`` (timed there: the card's eval
    wall), and the trainer's last chunked host forward, of the same
    params, is held against the card's logits at rtol = atol = 0.05.
    The CLI reads its partitions from the cache ``builds``
    (:class:`HostBuilds`) filled."""
    import tempfile

    import numpy as np

    from gist_tpu_torch.cli import infer, ist_distrib
    from gist_tpu_torch.models import sage
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.sampler import TILES_MIN_EDGES
    from gist_tpu_torch.train import ist_ultrawide as UW

    model = ["--dataset", "synth-reddit", "--n-hidden", "2048",
             "--n-layers", str(UW_CLI_LAYERS), "--normalize", "--use-f1"]
    chunked, real = [], sage.apply_chunked_host
    served_apply, device_eval_s = sage.apply, []

    def keep(*args, **kw):
        chunked.append(real(*args, **kw))
        return chunked[-1]

    def timed_apply(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        out = served_apply(*args, **kw)
        torch.cuda.synchronize()
        device_eval_s.append(time.time() - t0)
        return out

    parts = builds.get(torch, "uw_cli_partitions")
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        K.launches = 0
        t0 = time.time()
        sage.apply_chunked_host = keep
        try:
            r = ist_distrib.main(model + [
                "--ultra-wide", "--num_subnet", "8", "--iter_per_site",
                str(UW_CLI_STEPS), "--psize", str(UW_CLI_PSIZE),
                "--batch-size", "10", "--rnd-seed", str(UW_CLI_SEED),
                "--n-epochs", "8", "--lr", "1e-2", "--dropout", "0.2",
                "--weight-decay", "0", "--checkpoint-dir", ck,
                "--cache-dir", parts["cache_dir"]])
        finally:
            sage.apply_chunked_host = real
        torch.cuda.synchronize()
        train_wall = time.time() - t0
        launches = K.launches
        steps = len(r["round_wall_s"]) * 8 * UW_CLI_STEPS
        logits_path = os.path.join(tmp, "logits.npy")
        t0 = time.time()
        sage.apply = timed_apply
        try:
            served = infer.main(model + ["--checkpoint-dir", ck,
                                         "--logits-out", logits_path])
        finally:
            sage.apply = served_apply
        infer_wall = time.time() - t0
        card = np.load(logits_path)

    if len(chunked) != 1:
        raise RuntimeError(f"the trainer ran {len(chunked)} chunked evals, "
                           f"want one a round")
    host = chunked[-1]
    n_nodes = card.shape[0]
    err = np.abs(host - card)
    excess = float((err / (0.05 + 0.05 * np.abs(card))).max())
    nproc = procs.run_child(["nproc"], 60, capture_output=True, text=True)
    row = {"phase": "uw_cli_chunked_eval", "nodes": n_nodes,
           "n_layers": UW_CLI_LAYERS,
           "activation_elements": n_nodes * 2048,
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
    if n_nodes * 2048 <= UW.CHUNKED_EVAL_MIN_ELEMENTS:
        raise RuntimeError("synth-reddit at h2048 did not reach the "
                           "chunked eval")
    if len(r["losses"]) != 1 or len(device_eval_s) != 1:
        raise RuntimeError(f"expected 1 round with an eval and one card "
                           f"eval: {row}")
    # K1 a step: a forward aggregation a weight layer (n_layers + 1),
    # the same on the transpose but for layer 0's input
    per_step = 2 * UW_CLI_LAYERS + 1
    if launches != per_step * steps:
        raise RuntimeError(f"K1 launched {launches} times, want {per_step} "
                           f"per step ({per_step * steps})")
    if not all(e >= TILES_MIN_EDGES for e in r["edges_per_batch"]):
        raise RuntimeError("a batch fell under the layout's edge threshold")
    if not (np.isfinite(host).all() and np.isfinite(card).all()
            and host.shape == card.shape):
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


# Phase 20's bar, loop against fused (relative, per round): the two
# modes order their matrix products differently, and both sum the
# aggregations through S1 in edge order.  On the H100 they read 8.6e-8
# (1e-3 before, when the segment path's atomics moved the last bits
# between the runs).
IST_SIM_TOL = 5e-7


def phase_ist_simulation(torch):
    """The GIST simulation through its entry point, ``cli.train_ist``
    as a function: GCN h256, 2 layers, K=4 (the ``small-ist`` widths,
    split input and output) on synth-reddit-small with self loops and
    the random projection, ``iter_per_site`` 5, 10 epochs, dropout 0;
    once in loop mode, once ``--fused``.  The full graph carries no
    layout, so K1 launches 0 times and S1 carries every aggregation; the
    loop's losses averaged over each round equal the fused run's round
    losses within ``IST_SIM_TOL`` relative."""
    from gist_tpu_torch.cli import train_ist
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.ops import segment_csr as S

    argv = ["--dataset", "synth-reddit-small", "--n-hidden", "256",
            "--n-layers", "2", "--num_subnet", "4", "--iter_per_site", "5",
            "--n-epochs", "10", "--dropout", "0", "--split_output", "True"]
    out, launches, walls, s1 = {}, 0, {}, {}
    for mode, flags in (("loop", []), ("fused", ["--fused"])):
        K.launches = S.launches = 0
        t0 = time.time()
        out[mode] = train_ist.main(argv + flags)
        torch.cuda.synchronize()
        walls[mode] = time.time() - t0
        launches += K.launches
        s1[mode] = S.launches
    loop, fused = out["loop"], out["fused"]
    round_means = [sum(loop["losses"][i:i + 5]) / 5 for i in (0, 5)]
    diff = _rel_diff(round_means, fused["losses"])
    emit({"phase": "ist_simulation", "loop_losses": loop["losses"],
          "loop_round_means": round_means, "fused_losses": fused["losses"],
          "loss_rel_diff": diff, "tol": IST_SIM_TOL,
          "loop_val_acc": loop["val_accs"], "fused_val_acc": fused["val_accs"],
          "loop_mean_epoch_s": loop["mean_epoch_s"],
          "fused_mean_epoch_s": fused["mean_epoch_s"],
          "loop_kteps": loop["kteps"], "fused_kteps": fused["kteps"],
          "wall_s": walls, "k1_launches": launches, "s1_launches": s1})
    if launches != 0 or not all(s1.values()):
        raise RuntimeError(f"K1 launched {launches} times on a graph "
                           f"without a layout, S1 {s1}")
    if len(loop["losses"]) != 10 or len(fused["losses"]) != 2:
        raise RuntimeError("expected 10 epochs and 2 fused rounds")
    if not _finite(loop["losses"] + fused["losses"] + loop["val_accs"]):
        raise RuntimeError("non-finite loss or accuracy")
    if not diff <= IST_SIM_TOL:
        raise RuntimeError(f"loop and fused rounds differ by {diff}")
    return sum(s1.values())


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
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    row = {"phase": "gat_kernels", "kernel": name, "case": case,
           "max_abs_err": abs_err, "rel_err": rel_err, "tol": tol,
           "ms": kernel_ms(kernel),
           "call_ms": call_ms(kernel, reps=20),
           "plain_ms": call_ms(plain, reps=3),
           "segment_ms": kernel_ms(segment),
           "library_ms": None,
           "dz_library_ms": (None if dz_library is None
                             else kernel_ms(dz_library)),
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
              "one launch": kernel_ms(lambda: G.gat_fwd(*both)),
              "a launch per head": kernel_ms(
                  lambda: [G.gat_fwd(*a) for a in alone])}})
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


def phase_split_kernels(torch, device, g, builds):
    """K2 against its plain version on the synth-amazon2m-small split
    layouts (CU 1024 and 512), forward and transpose, F=100 in fp32 and
    bf16 and F=47 (the split path's layer-1 width) in fp32: every chunk
    in one pass, with times beside the plain walk's (the one call that
    is checked) and
    one ``torch.sparse.mm`` on the node-order adjacency.  The layouts
    come from ``builds`` (:class:`HostBuilds`).  Returns the rows and
    the CU=1024 layout pair (host tensors) for the split-path phase."""
    import numpy as np

    from gist_tpu_torch.ops import split_spmm as K2

    rng = np.random.default_rng(0)
    rows, keep = {}, None
    for cu in (1024, 512):
        fwd, bwd, build_s = builds.get(torch, f"split_{cu}")
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
                got = kernel()
                want, plain_ms = _timed(torch, plain)
                if not torch.isfinite(got.float()).all():
                    raise RuntimeError("K2 output is not finite")
                abs_err = float((got.float() - want.float()).abs().max())
                rel_err = abs_err / float(want.float().abs().max())
                tol = 1e-5 if dtype == torch.float32 else 1e-2
                bound_ms, bound_by, nbytes, flops = chunked_bound(
                    t, x, n_out)
                library_ms = library_call_ms = None
                if dtype == torch.float32:
                    library_ms = kernel_ms(
                        lambda: torch.sparse.mm(adj, x))
                    library_call_ms = call_ms(
                        lambda: torch.sparse.mm(adj, x), reps=10)
                ms = kernel_ms(kernel)
                row = {"phase": "split_kernels",
                       "case": f"{direction} CU={cu} F={f} "
                               f"{str(dtype).split('.')[-1]}",
                       "max_abs_err": abs_err, "rel_err": rel_err,
                       "tol": tol, "ms": ms,
                       "call_ms": call_ms(kernel, reps=10),
                       "plain_ms": plain_ms,
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


# Layouts that phases 10, 12 and 31 would build on the host, built by a
# child process (``host_builds``) while the phases before them run.


def host_builds(out_dir):
    """The child's work, in the order the phases need it, each saved
    (``torch.save``) to ``out_dir/<name>.pt`` as soon as it is built:
    phase 10's split layout pairs of synth-amazon2m-small (CU 1024 and
    512), phase 12's synth-reddit with self loops and its chunked layout
    pair, phase 31's ``amazon_spmm`` layouts (threshold 0 and 128, CU 512
    and 1024); for phase 32 the cost models' counts on the order of the
    CU-1024 v2 layout, and the partitions of ``record_r2``'s ultra-wide
    point (psize 1500) and of phase 18 (synth-reddit, psize 100), cached
    in ``out_dir/partitions``.  Each item carries its build seconds."""
    import numpy as np
    import torch

    from gist_tpu_torch.bench import amazon_spmm
    from gist_tpu_torch.bench.amazon_split_analysis import (THRESHOLDS,
                                                            split_counts)
    from gist_tpu_torch.bench.amazon_tn_analysis import tn_counts
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.sampler import ClusterSampler
    from gist_tpu_torch.train.full_graph import prepare_graph

    def save(name, obj):
        tmp = os.path.join(out_dir, f"{name}.tmp")
        torch.save(obj, tmp)
        os.replace(tmp, os.path.join(out_dir, f"{name}.pt"))

    ds_a = load_dataset("synth-amazon2m-small")
    g = graph_from_edges(ds_a.senders, ds_a.receivers, ds_a.n_nodes)
    for cu in (1024, 512):
        save(f"split_{cu}", _split_layouts(g, cu))
    del g
    t0 = time.time()
    ds = load_dataset("synth-reddit", self_loop=True)
    dataset_s = time.time() - t0
    t0 = time.time()
    graph = prepare_graph(ds, tiles=True)
    save("full_graph", {"ds": ds, "graph": graph, "dataset_s": dataset_s,
                        "layout_build_s": time.time() - t0})
    del ds, graph
    for threshold in (0, 128):
        for cu in (512, 1024):
            t0 = time.time()
            dc = amazon_spmm.build_layout(ds_a, threshold=threshold, cu=cu,
                                          chunk_rows=2 ** 13)
            save(f"amazon_spmm_{threshold}_{cu}", (dc, time.time() - t0))
            if (threshold, cu) == (0, 1024):
                pos = dc.pos.numpy().astype(np.int64)
    t0 = time.time()
    save("cost_counts", {
        "split": split_counts(64, ds_a.senders, ds_a.receivers, pos,
                              THRESHOLDS),
        "tn": tn_counts(64, pos[ds_a.senders], pos[ds_a.receivers]),
        "seconds": time.time() - t0})
    parts = os.path.join(out_dir, "partitions")
    t0 = time.time()
    ClusterSampler(ds_a, R2_UW_PSIZE, 10, cache_dir=parts, seed=0)
    save("r2_partitions", {"cache_dir": parts, "seconds": time.time() - t0})
    t0 = time.time()
    ClusterSampler(load_dataset("synth-reddit"), UW_CLI_PSIZE, 10,
                   cache_dir=parts, seed=UW_CLI_SEED)
    save("uw_cli_partitions", {"cache_dir": parts,
                               "seconds": time.time() - t0})


class HostBuilds:
    """:func:`host_builds` in a child process (``procs.run_child``, which
    ends its group) that a thread of this process waits for.
    :meth:`get` waits for one item and loads it; :meth:`close` joins the
    child and raises if it failed.  Should this process exit first (a
    phase raised), :meth:`stop` ends the child's group at exit."""

    def __init__(self, out_dir, timeout=1200):
        import atexit
        import threading
        self.out_dir, self.done, self.error = out_dir, None, None
        self.waited = {}
        os.makedirs(out_dir, exist_ok=True)
        self.thread = threading.Thread(target=self._run, args=(timeout,),
                                       daemon=True)
        self.thread.start()
        atexit.register(self.stop)

    def stop(self):
        """End the child's group if it still runs, and wait for the
        thread."""
        if self.thread.is_alive():
            procs.kill([pid for pid, cmd in procs.descendants()
                        if "chip_smoke.host_builds" in cmd])
            self.thread.join(timeout=30)
        shutil.rmtree(self.out_dir, ignore_errors=True)

    def _run(self, timeout):
        try:
            self.done = procs.run_child(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "chip_smoke.host_builds(sys.argv[1])", self.out_dir],
                timeout, cwd=HERE, capture_output=True, text=True)
        except BaseException as e:  # noqa: BLE001 - raised in close()
            self.error = e

    def close(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        if self.done.returncode:
            raise RuntimeError(f"the host builds failed:\n"
                               f"{self.done.stderr[-3000:]}")
        shutil.rmtree(self.out_dir, ignore_errors=True)

    def get(self, torch, name):
        """Item ``name``, once the child has saved it; the seconds this
        process waited for it go to ``waited``."""
        path = os.path.join(self.out_dir, f"{name}.pt")
        t0 = time.time()
        while not os.path.exists(path) and self.thread.is_alive():
            time.sleep(0.2)
        if not os.path.exists(path):
            self.close()
            raise RuntimeError(f"the host builds ended without {name}")
        self.waited[name] = time.time() - t0
        # mapped, not read: the pages come in as the phase moves them to
        # the card (the file stays readable once removed)
        item = torch.load(path, weights_only=False, mmap=True)
        os.remove(path)
        return item


def phase_full_path(torch, device, ds, graph, build):
    """The full-scale main path: ``train_full_graph`` with GCN h256, one
    hidden layer, dropout 0.5, lr 1e-2, weight decay 5e-4 and the LR
    schedule, 6 epochs on synth-reddit with self loops, on ``graph``
    (built by :class:`HostBuilds`, whose seconds ``build`` gives).
    The graph is above ``HUGE_EDGES``, so it carries the chunked pair
    and K1 runs once per chunk: per epoch 4 x C_f launches (layers 0 and
    1, train and eval) and 2 x C_t (their backward).  Returns the
    launches, the graph on the card and the rows of the chunked-K1
    check."""
    from gist_tpu_torch.models.gcn import GCNConfig
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.full_graph import train_full_graph

    layout_build_s = build["layout_build_s"]
    if graph.dedup_c is None or graph.dedup_c_t is None:
        raise RuntimeError("synth-reddit did not get the chunked layouts")
    cf, ct = graph.dedup_c.n_chunks, graph.dedup_c_t.n_chunks
    emit({"phase": "full_path", "nodes": ds.n_nodes, "edges": ds.n_edges,
          "layout_build_s": layout_build_s, "build_child": build,
          "n_chunks": [cf, ct],
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
        out_rows = t.n_chunks * t.tiles_per_chunk * t.tile_rows
        adj = _csr_adjacency(torch, graph, torch.float32, device,
                             transpose=direction == "bwd")
        for f in (256, 41):
            x = torch.from_numpy(rng.standard_normal(
                (n, f)).astype(np.float32)).to(device)
            got = K.run_dedup_chunked(t, x, n)
            want, plain_ms = _timed(torch, lambda: chunked_plain(
                t, x, n))
            seg, segment_ms = _timed(torch, lambda: spmm_segment_chunked(
                g, x))
            if not torch.isfinite(got).all():
                raise RuntimeError("chunked K1 output is not finite")
            abs_err = float((got - want).abs().max())
            rel_err = abs_err / float(want.abs().max())
            seg_err = float((got - seg).abs().max() / seg.abs().max())
            lib_err = float((got - torch.sparse.mm(adj, x)).abs().max()
                            / seg.abs().max())
            bound_ms, bound_by, _, flops = chunked_bound(t, x, out_rows)
            ms = kernel_ms(lambda: K.run_dedup_chunked(t, x, n),
                           windows=3)
            one_call_ms = call_ms(lambda: K.run_dedup_chunked(t, x, n),
                                  reps=5)
            library_ms = kernel_ms(lambda: torch.sparse.mm(adj, x),
                                   windows=3)
            library_call_ms = call_ms(
                lambda: torch.sparse.mm(adj, x), reps=5)
            row = {"phase": "full_path",
                   "case": f"run_dedup_chunked {direction} F={f} float32",
                   "n_chunks": t.n_chunks, "max_abs_err": abs_err,
                   "rel_err": rel_err, "segment_rel_err": seg_err,
                   "library_rel_err": lib_err, "tol": 1e-5, "ms": ms,
                   "call_ms": one_call_ms, "plain_ms": plain_ms,
                   "segment_ms": segment_ms, "library_ms": library_ms,
                   "library_call_ms": library_call_ms,
                   "library": "torch.sparse.mm on a CSR adjacency",
                   "ms_over_library": ms / library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "w_nonzero": flops // (2 * f),
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
    from gist_tpu_torch.bench import gat_chunked
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
        l0_bound = gat_chunked.fwd_bound(graph.dedup_c, z)
        row = {"phase": "gat_chunked", "k4_launches": launches,
               "max_abs_err": err, "rel_err": rel, "tol": 1e-4,
               "finite": bool(torch.isfinite(got).all()),
               "layer0_attention_ms": call_ms(
                   lambda: G.gat_attention_dedup_chunked(
                       graph, z, src, dst), reps=3, warmup=1),
               "layer0_bound_ms": l0_bound[0],
               "layer0_bound_by": l0_bound[1],
               "ms": call_ms(lambda: gat.apply(
                   params, graph, x, cfg, backend="dedup"), reps=3,
                   warmup=1),
               "segment_ms": call_ms(lambda: gat.apply(
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
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    row = {"phase": phase, "kernel": name, "case": case,
           "max_abs_err": abs_err, "rel_err": rel_err, "tol": tol,
           "ms": kernel_ms(kernel),
           "call_ms": call_ms(kernel, reps=20),
           "plain_ms": call_ms(plain, reps=plain_reps, warmup=1),
           **{k: None if fn is None else kernel_ms(fn)
              for k, fn in timers.items()},
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_bytes": nbytes, "useful_flops": flops}
    row.update({"gathered_bytes": gathered,
                "gathered_tb_s": gathered / row["ms"] / 1e9})
    if kernel_name:
        row.update({k.replace("_ms", "_call_ms"):
                    None if fn is None else call_ms(fn, reps=10)
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
                       "ms": kernel_ms(lambda: K3.run_plan(t, x, plan)),
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
        times = [[kernel_ms(fn) for _, _, fn, _ in runs]
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


# Phase 15's gradient bars, K7-K9 or K3 against the segment path (S1):
# GAT (max-relative on all leaves but the last attn, the last attn
# norm-wise) and GCN (norm-wise per leaf).  On the H100 they read 4.1e-6
# and 1.25e-4 (GAT) and 1.4e-7 (GCN); before S1 the bars were 1e-4, 5e-4
# and 1e-3, over the atomics' run-to-run spread.
V1_REF_BARS = {"gat": (4e-5, 5e-4), "gcn": 1e-6}


def phase_v1_reference(torch, device, ds, graph):
    """Two Adam steps (lr 1e-2, weight decay 5e-4) from one seeded
    initialisation on the full synth-reddit-small v1 graph, through the
    kernels and through the segment path (GAT h512, 2 heads, 2 layers,
    through K7-K9; GCN h256, 1 hidden layer, dropout 0, through K3):
    losses to 1e-4 relative.  Both paths sum in fixed orders, which
    differ, so the gradients are held to bars over the difference that
    order makes (``V1_REF_BARS``): GAT's first-step gradients max-relative
    per leaf, except the last layer's ``attn``, where a last-bit
    difference puts a score on the leaky ReLU's kink (it reads ~1.25e-4
    norm-wise, see PERF.md), held norm-wise; GCN's norm-wise per leaf.
    Both fp32 paths' errors against the segment path run in float64
    (S1's fp64 instance) are printed beside."""
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
            bars = V1_REF_BARS["gat"]
            row["grad_bars"] = (f"max-relative {bars[0]} on all leaves but "
                                f"the last attn; last attn norm-wise "
                                f"{bars[1]} (leaky-ReLU kink flips)")
            grad_ok = max(max_err[:-1]) <= bars[0] \
                and norm_err[-1] <= bars[1]
        else:
            bar = V1_REF_BARS["gcn"]
            row["grad_bars"] = f"norm-wise {bar} per leaf"
            grad_ok = max(norm_err) <= bar
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


# --- segment_csr: S1, the segment path's CSR row walk, and its repeats ------

# The flagship-shaped batches of the phase: synth-amazon2m-small cut into
# 750 clusters, 10 a batch (~1,300 nodes and 22,000-30,000 edges a batch,
# as the full flagship's psize 15000 on synth-amazon2m gives ~1,630
# nodes and a median of 20,332 edges), all under TILES_MIN_EDGES at the
# default threshold, so they take the segment path.  Its audit round:
# SAGE h2048, 4 hidden layers, K=8, 40 steps a subnet (one round of the
# 75 batches).  The GAT-GIST audit: GAT h512, 2 heads, 2 layers, K=2 on
# synth-reddit-small in 40 clusters, 4 a batch (~53,000 edges), one
# round of 10 steps a subnet.
SEG_PSIZE, SEG_BATCH, SEG_ITERS = 750, 10, 40
SEG_GAT_PSIZE, SEG_GAT_BATCH, SEG_GAT_ITERS = 40, 4, 10


def _s1_bound(indptr, x, idx, w, out):
    """S1's least time on these inputs, as ``bench/common.py:k1_bound``
    counts it: indptr, idx, w and the gathered rows' array read once,
    the output written once (real edges only), against one add a real
    edge and column (and one multiply where weighted)."""
    e = int(indptr[-1]) - int(indptr[0])
    f = out[0].numel()
    nbytes = (indptr.numel() * 4 + (e * 4 if idx is not None else 0)
              + (e * w[0].numel() * 4 if w is not None else 0)
              + x.numel() * x.element_size()
              + out.numel() * out.element_size())
    flops = e * f * (2 if w is not None else 1)
    return bound(nbytes, flops, x.dtype) + (nbytes, flops)


def _s1_row(torch, phase, case, indptr, x, idx=None, w=None,
            library=True):
    """S1 against its plain version (gather and ``index_add_``: fp32
    1e-5, bf16 1e-2 relative to the plain result's max) and against
    itself (two launches bitwise equal), with its times beside its bound
    and the rate of the rows it gathers (one ``f``-wide row a real edge
    and head) and, where ``library`` (the unweighted sums), PyTorch calls
    of the same sum timed as yardsticks: ``torch.sparse.mm`` over
    ``torch.sparse_csr_tensor(indptr, idx, ones)`` (``library_csr_ms``,
    the one call that computes S1's function; null where PyTorch has no
    kernel for the dtype), ``torch.segment_reduce`` over the gathered
    messages (the gather not timed) and ``index_add_`` under
    ``torch.use_deterministic_algorithms(True)``."""
    from gist_tpu_torch.ops import segment_csr as S

    def kernel():
        return S.segment_csr(indptr, x, idx, w)

    def plain():
        return S.segment_csr_reference(indptr, x, idx, w)
    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise RuntimeError(f"S1 output is not finite ({case})")
    abs_err = float((got.float() - want.float()).abs().max())
    rel_err = abs_err / max(float(want.float().abs().max()), 1e-30)
    tol = 1e-5 if x.dtype == torch.float32 else 1e-2
    bound_ms, bound_by, nbytes, flops = _s1_bound(indptr, x, idx, w, got)
    e = int(indptr[-1]) - int(indptr[0])
    gathered = e * got[0].numel() * got.element_size()
    row = {"phase": phase, "case": case, "rows": got.shape[0],
           "edges": int(indptr[-1]), "max_abs_err": abs_err,
           "rel_err": rel_err, "tol": tol,
           "bitwise_repeat": bool(torch.equal(got, again)),
           "plan": S.launch_plan(*_s1_key(indptr, x, w))._asdict(),
           "ms": kernel_ms(kernel), "call_ms": call_ms(kernel, reps=20),
           "plain_ms": call_ms(plain, reps=3), "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_bytes": nbytes, "useful_flops": flops,
           "gathered_bytes": gathered, "library_csr_ms": None,
           "library_ms": None, "library_det_ms": None}
    row["gathered_tb_s"] = gathered / row["ms"] / 1e9
    if library:
        e = int(indptr[-1])
        cols = idx[:e] if idx is not None else torch.arange(
            e, dtype=torch.int32, device=x.device)
        adj = torch.sparse_csr_tensor(
            indptr, cols, torch.ones(e, dtype=x.dtype, device=x.device),
            size=(got.shape[0], x.shape[0]))
        x2 = x.reshape(x.shape[0], -1)
        try:
            torch.sparse.mm(adj, x2)
            row["library_csr_ms"] = kernel_ms(lambda: torch.sparse.mm(adj,
                                                                      x2))
        except RuntimeError as err:   # no sparse kernel for the dtype
            row["library_csr_error"] = str(err).splitlines()[0][:200]
        msgs = x[:e] if idx is None else x.index_select(0, idx[:e].long())
        offsets = indptr.long()
        row["library_ms"] = kernel_ms(lambda: torch.segment_reduce(
            msgs, "sum", offsets=offsets, axis=0))
        rows = torch.repeat_interleave(
            torch.arange(got.shape[0], device=x.device),
            (indptr[1:] - indptr[:-1]).long(), output_size=e)
        src = idx[:e].long() if idx is not None else None

        def det():
            m = msgs if src is None else x.index_select(0, src)
            return torch.zeros_like(got).index_add_(0, rows, m)
        torch.use_deterministic_algorithms(True)
        try:
            row["library_det_ms"] = kernel_ms(det)
        finally:
            torch.use_deterministic_algorithms(False)
        row["library"] = ("torch.sparse.mm over the CSR tensor (ones); "
                          "torch.segment_reduce(sum) over the gathered "
                          "messages; gather and index_add_ under "
                          "use_deterministic_algorithms(True)")
        del msgs, rows, adj
    emit(row)
    if not (rel_err <= tol and row["bitwise_repeat"]):
        raise RuntimeError(f"S1 disagrees with its plain version or with "
                           f"itself: {row}")
    return row


def _s1_key(indptr, x, w):
    """(f, item, row alignment, segments) of an S1 call: ``launch_plan``'s
    key."""
    from gist_tpu_torch.ops import segment_csr as S
    heads = 1 if w is None or w.dim() == 1 else w.shape[1]
    f, item = x[0].numel() // heads, x.element_size()
    return (f, item, S.row_align(f, item, x.data_ptr()),
            (indptr.shape[0] - 1) * heads)


def _s1_shapes(torch, device, ds, ds_r):
    """S1's cases at the path's shapes, as (case, (indptr, v, idx, w),
    unweighted): a flagship-shaped batch at sub-width 256 and at F=100,
    forward and transpose, fp32 and bf16, with the GAT weighted sum (H=2,
    D=256, and D=41 as the output layer's classes) and the softmax
    denominators (F = heads = 2) on it; the headline synth-reddit-small
    graph at F=602 and F=256, forward and transpose."""
    import numpy as np

    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.sampler import ClusterSampler

    sampler = ClusterSampler(ds, SEG_PSIZE, SEG_BATCH, seed=0, tiles=False)
    batch = sampler.make_batch(next(sampler.iter_node_ids()))
    g = batch.graph.to(device)
    emit({"phase": "segment_csr", "batch_nodes": batch.n_real_nodes,
          "batch_edges": batch.n_real_edges, "n_pad": g.n_nodes,
          "e_pad": g.n_edges_padded})
    rng = np.random.default_rng(0)

    def rand(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype).to(device)
    shapes = []
    for f, dtype in ((256, torch.float32), (100, torch.float32),
                     (256, torch.bfloat16), (100, torch.bfloat16)):
        x = rand(g.n_nodes, f, dtype=dtype)
        tag = str(dtype).split(".")[-1]
        shapes.append((f"batch fwd F={f} {tag}", (g.indptr, x, g.senders,
                                                  None), True))
        shapes.append((f"batch bwd F={f} {tag}", (g.t_indptr, x,
                                                  g.t_senders, None), True))
    e = g.n_edges_padded
    alpha = torch.from_numpy(rng.random((e, 2)).astype(np.float32)).to(
        device)
    for d in (256, 41):
        shapes.append((f"batch weighted H=2 D={d} float32",
                       (g.indptr, rand(g.n_nodes, 2, d), g.senders, alpha),
                       False))
    shapes.append(("batch denominators H=2 float32",
                   (g.indptr, rand(e, 2), None, None), True))
    gr = graph_from_edges(ds_r.senders, ds_r.receivers,
                          ds_r.n_nodes).to(device)
    for f, x in ((602, torch.from_numpy(ds_r.features).to(device)),
                 (256, rand(gr.n_nodes, 256))):
        shapes.append((f"reddit fwd F={f} float32",
                       (gr.indptr, x, gr.senders, None), True))
        shapes.append((f"reddit bwd F={f} float32",
                       (gr.t_indptr, x, gr.t_senders, None), True))
    return shapes


def _s1_kernel_rows(torch, shapes):
    """S1's rows at the phase's shapes (``_s1_shapes``)."""
    return {case: _s1_row(torch, "segment_csr", case, *args,
                          library=unweighted)
            for case, args, unweighted in shapes}


def phase_s1_plans(torch, shapes):
    """S1's launch plans side by side at the segment path's shapes
    (``_s1_shapes``): every plan of ``plan_space`` at each, held bit for
    bit against the chosen plan's output (every plan sums each row in
    edge order, so all give the same bits), and timed like the kernels,
    every plan once a round over three rounds (``ms``: the median).
    Then, at the first shape (the flagship batch, F=256), S1 again with
    every index set to row 0 and with no edges.  Returns (one row a
    shape: the chosen plan, the fastest, their times; the probe)."""
    from gist_tpu_torch.ops import segment_csr as S

    out = []
    for case, (indptr, x, idx, w), _ in shapes:
        key = _s1_key(indptr, x, w)
        chosen = S.launch_plan(*key)
        plans = S.plan_space(*key[:3])
        if chosen not in plans:
            raise RuntimeError(f"S1's plan {chosen} for {case} is not in "
                               f"its plan space")
        want = S.run_plan(indptr, x, idx, w, chosen)
        for plan in plans:
            got = S.run_plan(indptr, x, idx, w, plan)
            if not torch.equal(got, want):
                raise RuntimeError(f"S1 plan {plan} differs from the chosen "
                                   f"{chosen} at {case}")
        del want, got
        fns = [lambda p=plan: S.run_plan(indptr, x, idx, w, p)
               for plan in plans]
        # every plan once a round, in turns, so drift falls on all alike
        times = [[kernel_ms(fn, windows=3, window_ms=2.0) for fn in fns]
                 for _ in range(3)]
        ms = [statistics.median(t[i] for t in times)
              for i in range(len(plans))]
        best = min(range(len(plans)), key=ms.__getitem__)
        row = {"phase": "s1_plans", "case": case, "key": list(key),
               "chosen": chosen._asdict(), "chosen_ms": ms[
                   plans.index(chosen)],
               "best": plans[best]._asdict(), "best_ms": ms[best],
               "plans": [[*p, m] for p, m in zip(plans, ms)]}
        emit(row)
        out.append(row)
    # where the flagship batch's time goes: the same launch with every
    # gather of row 0 (an L1 hit after the first) and with no edges at
    # all (the launch, the indptr loads and the stores)
    case, (indptr, x, idx, w), _ = shapes[0]
    row0, empty = torch.zeros_like(idx), torch.zeros_like(indptr)
    probe = {"phase": "s1_plans", "probe": case,
             "ms": kernel_ms(lambda: S.segment_csr(indptr, x, idx, w)),
             "row0_ms": kernel_ms(lambda: S.segment_csr(indptr, x, row0, w)),
             "no_edges_ms": kernel_ms(lambda: S.segment_csr(empty, x, idx,
                                                            w))}
    emit(probe)
    return out, probe


def _params_differ(torch, a, b):
    """The names of the parameter leaves of two checkpoints' ``params``
    whose bits differ."""
    return [f"layers.{i}.{k}" for i, (la, lb) in enumerate(
        zip(a["layers"], b["layers"])) for k in la
        if la[k].shape != lb[k].shape or not torch.equal(la[k], lb[k])]


def _audit_runs(torch, name, run):
    """``run(checkpoint_dir, cache_dir)`` twice from the same seed (the
    partitions cached by the first): the losses, accuracies and last
    checkpoint's parameters of the two runs must be bit for bit equal,
    and neither may launch K1.  Returns the row (the launches of each
    run)."""
    import tempfile

    from gist_tpu_torch.train.checkpoint import (latest_round_dir,
                                                 load_checkpoint)
    res = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_audit_") as tmp:
        for i in range(2):
            ck = os.path.join(tmp, str(i))
            reset_launch_counts()
            t0 = time.time()
            r = run(ck, os.path.join(tmp, "partitions"))
            torch.cuda.synchronize()
            res.append((r, launch_counts(), time.time() - t0,
                        load_checkpoint(latest_round_dir(ck))["params"]))
    (a, la, ta, pa), (b, lb, tb, pb) = res
    differ = _params_differ(torch, pa, pb)
    row = {"phase": "segment_csr", "audit": name, "losses": a["losses"],
           "repeat_losses": b["losses"], "val": a["val_accs"],
           "repeat_val": b["val_accs"],
           "losses_equal": a["losses"] == b["losses"],
           "val_equal": a["val_accs"] == b["val_accs"],
           "params_differ": differ, "launches": la,
           "repeat_launches": lb, "seconds": [ta, tb],
           "edges_per_batch_max": max(a.get("edges_per_batch") or [0])}
    emit(row)
    if not (row["losses_equal"] and row["val_equal"] and not differ):
        raise RuntimeError(f"audit {name}: two runs from one seed differ: "
                           f"{row}")
    if not la["S1"] or la != lb or la["K1"]:
        raise RuntimeError(f"audit {name}: launches {la} and {lb}")
    if not row["edges_per_batch_max"] < 200_000:
        raise RuntimeError(f"audit {name}: a batch over TILES_MIN_EDGES")
    return row


def _audit_sage_round(torch, ds):
    """One round of the flagship-shaped path on the segment path."""
    import dataclasses

    from gist_tpu_torch.models.sage import SAGEConfig
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.ist_ultrawide import train_ist_ultrawide

    cfg = SAGEConfig(100, 2048, 47, n_layers=4, dropout=0.2)
    tc = TrainConfig(lr=1e-2, weight_decay=0.0, n_epochs=8, num_subnet=8,
                     iter_per_site=SEG_ITERS)

    def run(ck, cache_dir):
        return train_ist_ultrawide(
            dataclasses.replace(ds), cfg, tc, psize=SEG_PSIZE,
            batch_size=SEG_BATCH, normalize=True, use_f1=True,
            cache_dir=cache_dir, eval_on_cpu=False, checkpoint_dir=ck,
            verbose=False, device="cuda")
    return _audit_runs(torch, "sage_h2048_k8_round", run)


def _audit_gat_step(torch, ds_r):
    """One round of GAT-GIST on batches under the threshold."""
    import dataclasses

    from gist_tpu_torch.models import gat
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.ist_cluster import train_ist_cluster

    cfg = gat.GATConfig(602, 512, 41, n_layers=2, n_heads=2)
    tc = TrainConfig(lr=1e-2, weight_decay=5e-4, n_epochs=2, num_subnet=2,
                     iter_per_site=SEG_GAT_ITERS)

    def run(ck, cache_dir):
        return train_ist_cluster(
            dataclasses.replace(ds_r), cfg, tc, psize=SEG_GAT_PSIZE,
            batch_size=SEG_GAT_BATCH, normalize=True, model=gat, kind="gat",
            cache_dir=cache_dir, checkpoint_dir=ck, verbose=False,
            device="cuda")
    row = _audit_runs(torch, "gat_h512_k2_round", run)
    if any(row["launches"][k] for k in ("K4", "K5", "K6")):
        raise RuntimeError(f"GAT audit took K4-K6: {row['launches']}")
    return row


def _segment_replay(torch, ds_r):
    """A segment-path step captured and replayed: ``train_cluster_gcn``
    with SAGE h256, 2 layers, dropout 0 on synth-reddit-small's
    under-threshold batches (psize 40, batch 4), 2 epochs, the loop
    against ``scan_batches=True`` (losses 1e-5 relative); every replay's
    trace must show S1, and K1 none.  Then S1 alone captured and
    replayed against its plain version (1e-5)."""
    import dataclasses

    import numpy as np

    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.models.sage import SAGEConfig
    from gist_tpu_torch.ops import segment_csr as S
    from gist_tpu_torch.train import capture
    from gist_tpu_torch.train.cluster import train_cluster_gcn
    from gist_tpu_torch.train.common import TrainConfig

    cfg = SAGEConfig(602, 256, 41, n_layers=2, dropout=0.0)
    tc = TrainConfig(lr=1e-2, weight_decay=0.0, n_epochs=2)

    def run(scan):
        return train_cluster_gcn(
            dataclasses.replace(ds_r), cfg, tc, psize=SEG_GAT_PSIZE,
            batch_size=SEG_GAT_BATCH, normalize=True, scan_batches=scan,
            verbose=False, device="cuda")
    reset_launch_counts()
    loop = run(False)
    torch.cuda.synchronize()
    loop_launches = launch_counts()
    capture.reset_stats()
    reset_launch_counts()
    with _replay_traces(torch) as traces:
        scan = run(True)
    torch.cuda.synchronize()
    at_capture = launch_counts()
    per_replay = [_count(p, "segment_csr_kernel") for p in traces]
    k1_per_replay = [_count(p, "dedup_spmm_kernel") for p in traces]
    rel = _rel_diff(scan["losses"], loop["losses"])
    g = graph_from_edges(ds_r.senders, ds_r.receivers,
                         ds_r.n_nodes).to("cuda")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (g.n_nodes, 256)).astype(np.float32)).cuda()
    err, prof = _replay_check(
        torch, lambda: (S.segment_csr(g.indptr, x, g.senders),),
        lambda got: (S.segment_csr_reference(g.indptr, x, g.senders),))
    row = {"phase": "segment_csr", "replay": "scan_batches_segment",
           "loop_losses": loop["losses"], "scan_losses": scan["losses"],
           "loss_max_rel_diff": rel, "replays": len(traces),
           "s1_per_replay_profiler": per_replay,
           "k1_per_replay_profiler": k1_per_replay,
           "loop_launches": loop_launches,
           "launches_at_capture": at_capture,
           "s1_alone_replay_rel_err": err,
           "s1_alone_in_trace": _count(prof, "segment_csr_kernel"),
           "note": REPLAY_COUNT_NOTE}
    emit(row)
    if not (len(per_replay) == tc.n_epochs and min(per_replay) > 0
            and max(k1_per_replay) == 0):
        raise RuntimeError(f"a replay of a segment-path step did not show "
                           f"S1: {row}")
    if not (loop_launches["S1"] and at_capture["S1"]
            and not loop_launches["K1"]):
        raise RuntimeError(f"segment-path steps: launches {row}")
    if not rel <= 1e-5:
        raise RuntimeError(f"scanned segment-path losses {rel} off the "
                           f"loop's")
    return loop_launches["S1"] + sum(per_replay)


def phase_segment_csr(torch, shapes, ds, ds_r):
    """S1 at the path's shapes (``_s1_shapes``), the audit's repeats (the
    flagship-shaped round and the GAT-GIST round, each run twice from one
    seed, bit for bit; the sharded GCN CLI's repeat is in phase 27) and a
    captured segment-path step.  Returns (S1's rows, its launches by
    path)."""
    rows = _s1_kernel_rows(torch, shapes)
    sage_row = _audit_sage_round(torch, ds)
    gat_row = _audit_gat_step(torch, ds_r)
    replay_launches = _segment_replay(torch, ds_r)
    launches = {
        "sage_ultrawide_segment": sage_row["launches"]["S1"]
        + sage_row["repeat_launches"]["S1"],
        "gat_gist_segment": gat_row["launches"]["S1"]
        + gat_row["repeat_launches"]["S1"],
        "scan_batches_segment": replay_launches}
    return rows, launches


# Phase 23's depth: 2 epochs (3 before), the second one steady.
SCAN_BATCHES_EPOCHS = 2


def phase_scan_batches(torch, ds, sampler):
    """``train_cluster_gcn`` with SAGE h256, 2 layers, dropout 0 on the
    main path's clusters (psize 50, batch 10, K1 on every batch, 5
    launches a step), 2 epochs, per-batch loop against
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
    tc = TrainConfig(lr=1e-2, weight_decay=0.0, n_epochs=SCAN_BATCHES_EPOCHS)
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
        lambda got: (chunked_plain(t, x, n),))
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
    procs.own_group()
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
                            rank=rank, world_size=world,
                            timeout=procs.rank_timeout(SPAWN_TIMEOUT_S))
    try:
        res = globals()[job](torch, rank, world, **args)
        with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump((res, warm_s), f)
    finally:
        dist.destroy_process_group()


# The seconds a world of phases 27-29 may take (each took 40-60 s on the
# H100's machine); past it every rank is ended and the phase raises.
SPAWN_TIMEOUT_S = 480


def _spawn_start(torch, world, job, **args):
    """Start ``job`` on ``world`` ranks of this card (each its own
    process, started with ``spawn``); returns the handle
    :func:`_spawn_wait` takes.  The kernels were built by the build
    phase, so no rank compiles."""
    import tempfile

    import torch.multiprocessing as mp
    backend = _backend(torch, world)
    work = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    torch.cuda.empty_cache()
    t0 = time.time()
    ctx = mp.start_processes(_rank_main,
                             args=(world, work, backend, job, args),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, job, world, backend, work, t0


def _spawn_wait(handle):
    """Wait for a :func:`_spawn_start` world (``SPAWN_TIMEOUT_S`` from
    now; ``procs.join_spawned`` ends its ranks however the wait ends);
    returns (backend, [each rank's result], seconds)."""
    import pickle
    ctx, job, world, backend, work, t0 = handle
    try:
        procs.join_spawned(ctx, SPAWN_TIMEOUT_S, f"phase job {job}")
        out, warm = [], []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                res, warm_s = pickle.load(f)
            out.append(res)
            warm.append(warm_s)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "spawn", "job": job, "world": world, "backend": backend,
          "seconds": time.time() - t0, "dynamo_import_s": warm})
    return backend, out, time.time() - t0


def _spawn(torch, world, job, **args):
    """:func:`_spawn_start` and :func:`_spawn_wait` in one."""
    return _spawn_wait(_spawn_start(torch, world, job, **args))


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
# the H100 SAGE and GAT read at most 1.3e-7.  GCN reads 0, 2.3e-5 and
# 4.0e-5 in every run: D=2 sums its boundary edges apart (S1) from its
# interior ones (K1), an order that differs from D=1's but is fixed, and
# Adam's first steps (lr times the sign of each gradient entry) turn its
# last bits into loss differences.  So GCN's first epoch is held
# exactly and the later ones within 1e-4 (1e-5, 1e-4, 1e-4 before, over
# the boundary sums' atomics); a GCN run with a bf16 halo reads 1.2e-5,
# 4.7e-4 and 1.8e-4, and the phase checks that this control reads over
# the bars.
SHARDED_CLI_BARS = {"sage": [1e-5] * 3, "gcn": [0.0, 1e-4, 1e-4],
                    "gat": [1e-5] * 3}
# Phase 29's bar on each round's mean loss, G=2 against G=1 (relative).
# A round is 8 Adam steps, whose first steps (lr times the sign of each
# gradient entry) turn last-bit differences of the summation order into
# loss differences: G=2 sums its boundary edges apart from its interior
# ones.  On the H100 round 1 reads 1.5e-5 at fp32 and 7.8e-5 with a bf16
# halo: its bar sits between, and the phase checks the bf16 control
# stays over it.  Round 2 reads 4.7e-4 (a bf16 halo 6.1e-4), so its bar
# only sits over that difference.  The same G=2 run repeated is held
# bit for bit (it differed by 3.1e-4 in round 2 while the segment
# path's boundary sums used atomics).  The 2-D script's run is held
# against its 1-D control at the same bars: at its own configuration
# (weight decay 0, init and boundaries seeded 0 and 11) the H100 read
# 1.0e-6 and 8.4e-5.
IST_2D_BARS = [4e-5, 1e-3]


def _loss_rel(got, ref):
    """Each epoch's |got - ref| / |ref|."""
    return [abs(a - b) / abs(b) for a, b in zip(got, ref)]


def _sharded_cli(torch, model, extra=()):
    """``cli.sharded_train`` as a function in the initialised group:
    (result, launches of this rank, seconds)."""
    from gist_tpu_torch.cli import sharded_train
    argv, _ = SHARDED_CLI[model]
    reset_launch_counts()
    t0 = time.time()
    r = sharded_train.main(["--dataset", "synth-reddit-small",
                            "--n-layers", "2", "--dropout", "0",
                            "--n-epochs", str(SHARDED_EPOCHS)] + argv
                           + list(extra))
    torch.cuda.synchronize()
    if not r["interior_tiles"]:
        raise RuntimeError(f"sharded {model}: no interior tiles")
    return {"losses": r["losses"], "val_accs": r["val_accs"],
            "train_time": r["train_time"], "launches": launch_counts(),
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

    from gist_tpu_torch.bench.scaling_projection import ring_shift_rate
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
    reset_launch_counts()
    y = agg(x)
    (y * w).sum().backward()
    torch.cuda.synchronize()
    out["agg_launches"] = launch_counts()
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
        rounding = agg(x.abs()) * 2.0 ** -8 + 1e-6
        y32 = agg(x)
    err16 = (y16 - y32).abs()
    out["bf16_within_rounding"] = bool((err16 <= rounding).all())
    out["bf16_max_over_bound"] = float((err16 / rounding).max())
    # the link these ranks use: a ring exchange of the halo rows at F=602
    out["ring_rate"] = ring_shift_rate(sg, mesh, x.detach())

    # the sharded GAT attention: K4's partial softmax merged with the
    # boundary partials, against the segment path on the same halo
    da = device_arrays(sg, mesh)
    g_rng = torch.Generator(device=dev).manual_seed(1 + rank)
    z = torch.randn((n, 2, 512), generator=g_rng, device=dev)
    src, dst = (torch.randn((n, 2), generator=g_rng, device=dev)
                for _ in range(2))
    with torch.no_grad():
        reset_launch_counts()
        att = sharded_gat_attention(sg, z, src, dst, da)
        out["gat_k4_launches"] = launch_counts()["K4"]
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
            bound_ms, bound_by, _, _ = k1_bound(t, xi, got.shape[0])
            rows[f"interior {direction} F=602 float32"] = {
                "case": f"interior {direction} F=602 float32",
                "max_abs_err": abs_err,
                "rel_err": abs_err / float(want.abs().max()),
                "ms": kernel_ms(kernel),
                "plain_ms": call_ms(plain, reps=2),
                "bound_ms": bound_ms, "bound_by": bound_by}
        out["k1_interior"] = rows
    del x, w, y, y_full, dx_full, da
    torch.cuda.empty_cache()
    out["cli"] = {m: _sharded_cli(torch, m) for m in SHARDED_CLI}
    # the same GCN run again: its boundary sums (S1) and interior ones
    # (K1) keep one order, so it must repeat bit for bit
    out["cli_gcn_repeat"] = _sharded_cli(torch, "gcn")
    # the control of the CLI bars: a bf16 halo, a real loss of precision
    # on the wire, must read over them
    out["cli_gcn_bf16"] = _sharded_cli(torch, "gcn", BF16_HALO)
    return out


def _sharded_d1_in_parent(torch):
    """Phase 27's one-rank part, in this process on a one-rank nccl
    group: ``bench/sharded.py``'s step measurement (the card's time of
    the sharded aggregation at D=1, with interior K1 tiles and on the
    segment path, against the flat K1 aggregation of the same graph,
    F=602, forward), one sharded SAGE step's gradients at h256 and h128,
    and the three sharded CLI runs at D=1."""
    import tempfile

    import torch.distributed as dist

    from gist_tpu_torch.bench import sharded
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.parallel import comm

    work = tempfile.mkdtemp(prefix="chip_smoke_d1_")
    dist.init_process_group("nccl", init_method=f"file://{work}/rdv",
                            rank=0, world_size=1)
    try:
        ds = load_dataset("synth-reddit-small")
        dev = torch.device("cuda")
        mesh = comm.make_mesh("cuda", (1,), ("graph",))
        t0 = time.time()
        t, sg = sharded.step_bench(ds, mesh, dev)
        t["step_bench_s"] = time.time() - t0
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
    reset_launch_counts()
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
    return {k: r[k] for k in keep}, launch_counts(), time.time() - t0


def _job_ist_mesh(torch, rank, world, names, cache_dir):
    """Phase 28's mesh runs ``names`` on a subnet mesh of all ranks."""
    from gist_tpu_torch.ist.distributed import make_subnet_mesh
    mesh = make_subnet_mesh(world, "cuda")
    return {n: _ist_run(torch, n, cache_dir, mesh) for n in names}


# Phase 29: cli.sharded_train --ist-subnets 2 at benchmarks/
# ist_sharded_2d.py's configuration (SAGE h128, 2 layers, lr 1e-2,
# synth-reddit-small), 2 rounds of 8 steps; the graph dim cut from 4 to
# 2 (4 ranks on the card).  K1 per rank: 5 a step (3 forward, 2
# transpose); the eval runs the flat graph's segment path.  Beside it,
# once, ``gist_tpu_torch/bench/ist_sharded_2d.py:run`` at the same cut:
# the script's 2-D run (the same K1 launches) and its 1-D control (the
# flat graph's segment path).
IST_2D_ROUNDS, IST_2D_STEPS = 2, 8


def _ist_2d_cli(torch, world, extra=()):
    from gist_tpu_torch.cli import sharded_train
    reset_launch_counts()
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
            "launches": launch_counts(), "seconds": time.time() - t0}


def _ist_2d_script(torch, ds, world):
    """The 2-D script's run and its 1-D control on S=2 x G=world/2
    ranks, with this rank's launches and seconds."""
    from gist_tpu_torch.bench import ist_sharded_2d
    reset_launch_counts()
    t0 = time.time()
    r = ist_sharded_2d.run(ds, "cuda", subnets=2, graph=world // 2,
                           rounds=IST_2D_ROUNDS, steps=IST_2D_STEPS,
                           hidden=128)
    torch.cuda.synchronize()
    if not r["interior_tiles"]:
        raise RuntimeError("2-D script: no interior tiles")
    return {"curves": r["curves"], "mesh": r["mesh"],
            "max_val_gap": r["max_val_gap_2d_vs_1d"],
            "comm_per_step": r["comm_per_step"],
            "launches": launch_counts(), "seconds": time.time() - t0}


def _check_ist_2d_script(ranks):
    """Phase 29's bars on the 2-D script (one record a rank): every rank
    returns rank 0's 2-D losses and both runs' accuracies (evaluated on
    rank 0 and handed out), and on every rank the 1-D control's round
    losses are within ``IST_2D_BARS`` of the 2-D run's.  Each graph
    column trains its own copy of the control on the segment path, which
    sums in one order (S1), so the ranks' control losses must be equal
    bit for bit."""
    c0 = ranks[0]["curves"]
    for r in ranks:
        c2, c1 = r["curves"]["2d"], r["curves"]["1d"]
        if c1["loss"] != c0["1d"]["loss"]:
            raise RuntimeError(f"2-D script: the graph columns' 1-D "
                               f"controls differ: {c1['loss']} and "
                               f"{c0['1d']['loss']}")
        if c2["loss"] != c0["2d"]["loss"] or any(
                r["curves"][tag][key] != c0[tag][key]
                for tag in ("2d", "1d") for key in ("val", "test")):
            raise RuntimeError("2-D script: ranks return other curves")
        if not (_finite(c2["loss"]) and _finite(c1["loss"]) and all(
                e <= tol for e, tol in
                zip(_loss_rel(c2["loss"], c1["loss"]), IST_2D_BARS))):
            raise RuntimeError(f"2-D script: the 2-D run's losses "
                               f"{c2['loss']} off its 1-D control's "
                               f"{c1['loss']} (bars {IST_2D_BARS})")


def _job_ist_2d(torch, rank, world):
    """Phase 29 on S=2 x G=world/2 ranks: the CLI, the witnesses of its
    bar (the same run again, and a bf16-halo control), the 2-D script
    with its 1-D control once, then one sharded SAGE h128 step's
    gradients over the 2-D mesh's graph dim."""
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.parallel import build_sharded_graph
    from gist_tpu_torch.parallel.ist_sharded import make_ist_graph_mesh
    out = _ist_2d_cli(torch, world)
    out["repeat"] = _ist_2d_cli(torch, world)
    out["bf16"] = _ist_2d_cli(torch, world, BF16_HALO)
    ds = load_dataset("synth-reddit-small")
    out["script"] = _ist_2d_script(torch, ds, world)
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
    if not (d1_times["sharded_d1_kernel_rel_err"] <= 1e-5
            and d1_times["sharded_d1_segment_rel_err"] <= 1e-5):
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
    repeats = [{"losses": r["cli"]["gcn"]["losses"],
                "repeat_losses": r["cli_gcn_repeat"]["losses"],
                "val": r["cli"]["gcn"]["val_accs"],
                "repeat_val": r["cli_gcn_repeat"]["val_accs"],
                "s1_launches": [r["cli"]["gcn"]["launches"]["S1"],
                                r["cli_gcn_repeat"]["launches"]["S1"]]}
               for r in ranks]
    emit({"phase": "sharded_graph", "audit": "sharded_gcn_cli_repeat",
          "ranks": repeats})
    for rep in repeats:
        if rep["losses"] != rep["repeat_losses"] \
                or rep["val"] != rep["repeat_val"] \
                or not rep["s1_launches"][0] \
                or rep["s1_launches"][0] != rep["s1_launches"][1]:
            raise RuntimeError(f"the D=2 sharded GCN CLI did not repeat "
                               f"bit for bit: {rep}")
    launches["S1"] = sum(
        r["agg_launches"]["S1"] + r["cli_gcn_repeat"]["launches"]["S1"]
        + r["cli_gcn_bf16"]["launches"]["S1"]
        + sum(c["launches"]["S1"] for c in r["cli"].values())
        for r in ranks) + sum(c["launches"]["S1"] for c in d1_cli.values())
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
    ultra-wide mesh) and four (phase 29's 2 x 2 mesh), the two and the
    four at once.  Returns the
    launches by phase and kernel, K1's interior rows, and the ring rate
    of phase 27's slower rank (``ring_shift_rate``)."""
    import tempfile
    t_ref = time.time()
    d1_times, d1_grads, d1_cli = _sharded_d1_in_parent(torch)
    d1_s = time.time() - t_ref
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_parts_")
    loops = {name: _ist_run(torch, name, cache_dir)
             for name in _ist_mesh_runs()}
    ref_s = time.time() - t_ref
    # the two- and four-rank worlds run at once, then the eight-rank one
    pair_h = _spawn_start(torch, 2, "_job_pair", cache_dir=cache_dir)
    two_d_h = _spawn_start(torch, 4, "_job_ist_2d")
    try:
        pair_backend, pair, pair_s = _spawn_wait(pair_h)
    except BaseException:
        procs.end_ranks(two_d_h[0].processes)
        raise
    b4, r4, s4 = _spawn_wait(two_d_h)
    uw_backend, uw, uw_s = _spawn(torch, 8, "_job_ist_mesh",
                                  names=["ultrawide"], cache_dir=cache_dir)
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
          "ring_rate": [r["ring_rate"] for r in sg_ranks],
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
    script = r4[0]["script"]
    c2, c1 = script["curves"]["2d"], script["curves"]["1d"]
    emit({"phase": "ist_sharded_2d", "script": "ist_sharded_2d",
          "backend": b4, "world": 4, "mesh": script["mesh"],
          "seconds": [r["script"]["seconds"] for r in r4],
          "curves": script["curves"], "max_val_gap": script["max_val_gap"],
          "loss_rel_2d_vs_1d": _loss_rel(c2["loss"], c1["loss"]),
          "control_losses_per_rank": [r["script"]["curves"]["1d"]["loss"]
                                      for r in r4],
          "bars": IST_2D_BARS, "comm_per_step": script["comm_per_step"],
          "launches_per_rank": [r["script"]["launches"] for r in r4]})

    # every line is out before the first check can raise
    launches = {"sharded_graph": _check_sharded_graph(sg_ranks, d1_times,
                                                      d1_grads, d1_cli),
                "ist_mesh": dict.fromkeys(("K1", "K4", "K5", "K6"), 0)}
    for name, (_, _, ranks) in meshes.items():
        for k, v in _check_ist_mesh(name, ranks, loops[name][0]).items():
            launches["ist_mesh"][k] += v
    want = 5 * IST_2D_ROUNDS * IST_2D_STEPS
    runs_2d = ref2 + [x for r in r4 for x in (r, r["repeat"], r["bf16"])]
    for r in runs_2d + [r["script"] for r in r4]:
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
    got = r4[0]["losses"]
    if not _finite(got) or not all(
            e <= tol for e, tol in
            zip(_loss_rel(got, ref2[0]["losses"]), IST_2D_BARS)):
        raise RuntimeError(f"2-D mesh losses {got} off the S=2 x G=1 "
                           f"run's {ref2[0]['losses']} (bars "
                           f"{IST_2D_BARS})")
    # the same run repeated sums in the same order everywhere (K1 inside
    # the shards, S1 over the boundary): bit for bit
    if r4[0]["repeat"]["losses"] != got \
            or r4[0]["repeat"]["val_accs"] != r4[0]["val_accs"]:
        raise RuntimeError(f"2-D mesh: the repeated run "
                           f"{r4[0]['repeat']['losses']} is not the first "
                           f"one {got}")
    if not _loss_rel(r4[0]["bf16"]["losses"][:1],
                     ref2[0]["losses"][:1])[0] > IST_2D_BARS[0]:
        raise RuntimeError(f"the 2-D round-1 bar does not tell a bf16 halo "
                           f"apart: {r4[0]['bf16']['losses']} against "
                           f"{ref2[0]['losses']}")
    _check_ist_2d_script([r["script"] for r in r4])
    launches["ist_sharded_2d"] = {
        k: sum(r["launches"][k] for r in runs_2d)
        + sum(r["script"]["launches"][k] for r in r4) for k in ("K1", "S1")}
    ring = min((r["ring_rate"] for r in sg_ranks),
               key=lambda v: v["bytes_per_s"])
    return launches, r0["k1_interior"], ring


# --- bench: the benchmark layer (gist_tpu_torch/bench/) ----------------

# Phase 30's scripts, each run once at its default size: (name, module,
# arguments).  The GAT script runs its train step on both layouts (K4-K6
# on dedup, K7-K9 on gather).
BENCH_SCRIPTS = (
    ("spmm", "spmm", []),
    ("kernel_tune", "kernel_tune", []),
    ("gat_dedup_train_step", "gat", ["--layout", "dedup", "--train-step"]),
    ("gat_gather_train_step", "gat", ["--layout", "gather",
                                      "--train-step"]),
    ("sharded", "sharded", []),
)
# the GAT train step's first-step gradients, each configuration against
# the segment backend's: per leaf the norm of the difference over the
# segment gradient's norm (phase 8 holds K4-K6's to 1e-4 max-relative)
GAT_GRAD_TOL = 1e-4
# the bench's SAGE train step, the first step's gradients through K1
# against the segment path's, per leaf by norm.  The first layer's weight
# reads 8.2e-4 on the H100 in every run: K1 and S1 each sum in a fixed
# order, and the two orders put a ReLU input on the other side of 0 now
# and then.  The bar sits ~5x over it (1e-2 before, over the atomics'
# run-to-run spread).  K1's own error is held at 1e-5 on the same shapes
# without the ReLUs (``k1_fwd_f256``, ``k1_transpose_f256``).
SAGE_GRAD_TOL = 4e-3


def _bench_entry(torch, card):
    """``python3 bench_torch.py`` from the checkout's root: exactly one JSON
    line, every key of the JAX bench but those not carried over, every
    number of them positive, ``hardware`` naming this card, K1's bound
    share at most 1 and K1 and K4 launched."""
    from gist_tpu_torch.bench import entry
    t0 = time.time()
    env = {k: v for k, v in os.environ.items() if k != "GIST_BENCH_FAST"}
    res = procs.run_child([sys.executable, "bench_torch.py"], 900, cwd=HERE,
                          env=env, capture_output=True, text=True)
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    if res.returncode or len(lines) != 1:
        raise RuntimeError(f"bench_torch.py: exit code {res.returncode}, "
                           f"{len(lines)} lines:\n{res.stdout[-3000:]}\n"
                           f"{res.stderr[-3000:]}")
    rec = json.loads(lines[0])
    emit({"phase": "bench", "entry": rec, "seconds": time.time() - t0})
    want = set(entry.JAX_KEYS) - set(entry.NOT_CARRIED)
    bad = sorted(want - set(rec)) + [
        k for k in sorted(want & set(rec))
        if isinstance(rec[k], (int, float)) and not rec[k] > 0]
    if bad or "error" in rec or rec["hardware"] != card["name"] or not (
            0 < rec["fp32_bound_share"] <= 1) or not all(
            rec["kernel_launches"].get(k) for k in ("K1", "K4")):
        raise RuntimeError(f"bench_torch.py's line fails its checks "
                           f"(missing or not positive: {bad}): {rec}")
    return rec


def _bench_scripts(torch):
    """Each script of ``BENCH_SCRIPTS`` once, in this process; its lines
    are printed and checked: times positive; K1 at every tile size over
    its bound, within its bar of its plain walk and bitwise equal over
    two launches (``kernel_tune``'s rows: synth-reddit-small's forward
    layout at TN 64, 128 (the entry's headline layout) and 256, fp32 to
    1e-5 and bf16 to 1e-2); the GAT train step's three configurations'
    losses within 1e-4 of each other and their first-step gradients
    within ``GAT_GRAD_TOL`` of the segment backend's; the sharded D=1
    aggregation within 1e-5 of the flat one and the sharded GCN forward
    within 1e-4 (its LayerNorm moments are summed in another order,
    three layers deep)."""
    import importlib
    import io
    out = {}
    for name, module, argv in BENCH_SCRIPTS:
        mod = importlib.import_module(f"gist_tpu_torch.bench.{module}")
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out[name] = mod.main(argv)
        emit({"phase": "bench", "script": name, "argv": argv,
              "seconds": time.time() - t0,
              "lines": [json.loads(ln) for ln in buf.getvalue().splitlines()
                        if ln.strip()]})
    times = [r["ms"] for r in out["spmm"]] + [
        r["ms"] for r in out["kernel_tune"]["rows"]] + [
        r["ms_per_step"] for k in ("gat_dedup_train_step",
                                   "gat_gather_train_step")
        for r in out[k] if "ms_per_step" in r]
    if not all(t > 0 for t in times):
        raise RuntimeError(f"a benchmark time is not positive: {times}")
    for r in out["kernel_tune"]["rows"]:
        if not (r["bound_ms"] <= r["ms"] and r["rel_err"] <= r["tol"]
                and r["bitwise_repeat"]):
            raise RuntimeError(f"K1 under its bound, off its plain walk or "
                               f"not repeatable: {r}")
    for k in ("gat_dedup_train_step", "gat_gather_train_step"):
        steps = [r for r in out[k] if "ms_per_step" in r]
        for key in ("loss_first", "loss_last"):
            ref = steps[0][key]
            if not all(abs(r[key] - ref) <= 1e-4 * abs(ref) for r in steps):
                raise RuntimeError(f"{k}: the configurations' {key} "
                                   f"differ: {steps}")
        if not all(r["grad_norm_rel_err"] <= GAT_GRAD_TOL for r in steps):
            raise RuntimeError(f"{k}: a configuration's first-step "
                               f"gradients are off the segment backend's: "
                               f"{steps}")
    step, gcn = out["sharded"]["step"], out["sharded"]["gcn"]
    if not (step["sharded_d1_kernel_rel_err"] <= 1e-5
            and step["sharded_d1_segment_rel_err"] <= 1e-5
            and gcn["sharded_rel_err"] <= 1e-4):
        raise RuntimeError(f"sharded D=1 off the flat path: {out['sharded']}")
    return out


def _norm_rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _bench_checks(torch, device, graft, graft_out):
    """The entry's sections that ``kernel_tune`` does not cover, held on
    the entry's own inputs against their plain versions (these launches
    are not counted):

    * K1 forward and K1 on the transpose layout at the train step's
      width (F=256, the hidden layers' aggregations): the output and the
      input's gradient for a seeded output gradient, against the segment
      path, to 1e-5 relative to the max;
    * the SAGE train step's first step through K1 against the segment
      path: the loss to 1e-5 relative, each leaf's gradient to
      ``SAGE_GRAD_TOL`` by norm.  Beside it, the segment path against
      itself with its edge order reversed: summation-order noise flips a
      ReLU input's sign now and then, and that alone moves the first
      layers' gradients (phase 4's finding; here the first layer's
      weight reads 8.2e-4 by norm); a wrong aggregation moves them by
      O(1);
    * K4 at D=128 against the segment attention, K1 once per chunk on
      synth-amazon2m-small's TN-64 chunked layout (the entry's cache)
      against the segment aggregation, and the graft entry's forward on
      the card against the same forward on the segment path, each to
      1e-5 relative to the max."""
    from gist_tpu_torch.bench import entry
    from gist_tpu_torch.bench.common import rel_err
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.graph import graph_from_edges
    from gist_tpu_torch.models import sage
    from gist_tpu_torch.ops import dedup_spmm as K
    from gist_tpu_torch.ops import spmm
    from gist_tpu_torch.ops.gat_dedup import gat_attention_dedup
    from gist_tpu_torch.ops.segment import gat_attention_segment

    ds = load_dataset(entry.DATASET)
    g = graph_from_edges(ds.senders, ds.receivers, ds.n_nodes,
                         tiles=True).to(device)
    x = torch.from_numpy(ds.features).to(device)
    checks = {}
    gen = torch.Generator(device=device).manual_seed(1)
    h = torch.randn(ds.n_nodes, 256, generator=gen, device=device)
    gy = torch.randn(ds.n_nodes, 256, generator=gen, device=device)
    out = {}
    for backend in ("dedup", "segment"):
        hb = h.clone().requires_grad_(True)
        y = spmm.aggregate(g, hb, backend=backend)
        y.backward(gy)
        out[backend] = (y.detach(), hb.grad)
    checks["k1_fwd_f256"] = (out["dedup"][0], out["segment"][0])
    checks["k1_transpose_f256"] = (out["dedup"][1], out["segment"][1])
    del h, gy, out

    labels = torch.from_numpy(ds.labels).to(device)
    mask = torch.from_numpy(ds.train_mask).to(device)
    cfg = entry.sage_config(ds)
    init = sage.init(torch.Generator().manual_seed(0), cfg)
    flipped = _reversed_edges(g)
    first = {}
    for name, graph, backend in (("dedup", g, "dedup"),
                                 ("segment", g, "segment"),
                                 ("reversed", flipped, "segment")):
        params = {"layers": [{k: v.clone().to(device) for k, v in l.items()}
                             for l in init["layers"]]}
        n0 = K.launches
        loss = entry.sage_step(params, graph, x, labels, mask, cfg,
                               backend)()
        first[name] = (float(loss), K.launches - n0, [
            t.grad.clone() for l in params["layers"] for t in l.values()])
    del flipped
    (kl, kn, kg), (sl, sn, sg) = first["dedup"], first["segment"]
    grad_err = [_norm_rel(a, b) for a, b in zip(kg, sg)]
    row = {"phase": "bench", "check": "sage_train_step", "loss_k1": kl,
           "loss_segment": sl, "loss_rel_err": abs(kl - sl) / abs(sl),
           "grad_norm_rel_err_per_leaf": grad_err,
           "grad_max_rel_err_per_leaf": [rel_err(a, b)
                                         for a, b in zip(kg, sg)],
           "segment_reversed_norm_rel_err_per_leaf": [
               _norm_rel(a, b) for a, b in zip(first["reversed"][2], sg)],
           "tol_loss": 1e-5, "tol_grad": SAGE_GRAD_TOL,
           "k1_launches": kn, "segment_k1_launches": sn}
    emit(row)
    if not (row["loss_rel_err"] <= 1e-5 and max(grad_err) <= SAGE_GRAD_TOL
            and kn > 0 and sn == 0):
        raise RuntimeError(f"the bench's train step through K1 disagrees "
                           f"with the segment path: {row}")

    z, av, bv = entry.gat_inputs(x, g.n_nodes)
    with torch.no_grad():
        checks["gat_d128"] = (gat_attention_dedup(g, z, av, bv, 0.01),
                              gat_attention_segment(g, z, av, bv, 0.01))
    del g, x, z

    ds_a = load_dataset(entry.CHUNKED_DATASET)
    dc = entry.chunked_layout(ds_a, entry.CHUNKED_DATASET,
                              os.path.join(HERE, "data")).to(device)
    g_a = graph_from_edges(ds_a.senders, ds_a.receivers,
                           ds_a.n_nodes).to(device)
    x_a = torch.from_numpy(ds_a.features).to(device)
    with torch.no_grad():
        checks["chunked_tn64"] = (
            K.run_dedup_chunked(dc, x_a, ds_a.n_nodes),
            spmm.aggregate(g_a, x_a, backend="segment"))
        spmm.set_default_backend("segment")
        try:
            checks["graft_entry"] = (graft_out, graft[0](*graft[1]))
        finally:
            spmm.set_default_backend("auto")
    for name, (got, want) in checks.items():
        row = {"phase": "bench", "check": name, "shape": list(got.shape),
               "max_abs_err": float((got - want).abs().max()),
               "rel_err": rel_err(got, want), "tol": 1e-5,
               "finite": bool(torch.isfinite(got).all())}
        if name == "chunked_tn64":
            row.update(tile_rows=dc.tile_rows, n_chunks=dc.n_chunks)
        emit(row)
        if not (row["rel_err"] <= 1e-5 and row["finite"]
                and got.shape == want.shape):
            raise RuntimeError(f"the bench's {name} disagrees with its "
                               f"plain version: {row}")


def phase_bench(torch, device, card):
    """Phase 30, the benchmark path: every launch count set to 0, the
    entry in its own process (its launches come back in its line), the
    graft entry's forward and each script once; then the sections'
    checks.  Returns the launches by kernel and ``kernel_tune``'s K1
    rows."""
    from gist_tpu_torch import graft_entry
    reset_launch_counts()
    rec = _bench_entry(torch, card)
    n0 = launch_counts()["K1"]
    graft = graft_entry.entry()
    with torch.no_grad():
        graft_out = graft[0](*graft[1])
    graft_k1 = launch_counts()["K1"] - n0
    scripts = _bench_scripts(torch)
    launches = launch_counts()
    for k, n in rec["kernel_launches"].items():
        launches[k] += n
    emit({"phase": "bench", "launches": launches,
          "entry_launches": rec["kernel_launches"],
          "graft_entry_k1_launches": graft_k1})
    missing = [k for k in ("K1", "K4", "K5", "K6", "K7", "K8", "K9")
               if not launches[k]]
    if missing or not graft_k1:
        raise RuntimeError(f"the benchmark path never launched {missing}"
                           f" (graft entry's K1: {graft_k1})")
    _bench_checks(torch, device, graft, graft_out)
    torch.cuda.empty_cache()
    return launches, scripts["kernel_tune"]["rows"]


# --- fullscale_scripts: the full-scale benchmark scripts (phase 31) -------

# the scripts' bars: every kernel against its plain walk and the segment
# path (fp32 sums in a fixed order), the zero-score attention, the
# resumed loss and F1 (the same numbers read back), Cluster-GCN's losses
FULLSCALE_TOL = 1e-5


def _fullscale_spmm(torch, device, ds_a, g_a, builds):
    """``amazon_spmm`` at threshold 0 and 128, CU 512 and 1024, on the
    layouts of ``builds`` (:class:`HostBuilds`): (rows, the host v2
    layout at CU 1024, phase 32's locality order)."""
    from gist_tpu_torch.bench import amazon_spmm
    rows, v2 = [], None
    for threshold in (0, 128):
        for cu in (512, 1024):
            t0 = time.time()
            dc, build_s = builds.get(torch, f"amazon_spmm_{threshold}_{cu}")
            rec = amazon_spmm.run(ds_a, dc, device, iters=3,
                                  segment_iters=3, plain=True, seg_graph=g_a)
            rec.update(layout=amazon_spmm.layout_name(threshold, cu),
                       layout_build_s=build_s, seconds=time.time() - t0)
            emit({"phase": "fullscale_scripts", "script": "amazon_spmm",
                  **rec})
            kernel = "K2" if threshold else "K1"
            if not (rec["plain_rel_err"] <= FULLSCALE_TOL
                    and rec["rel_err_vs_segment"] <= FULLSCALE_TOL
                    and rec["finite"] and rec["kernel"] == kernel
                    and rec["kernel_launches"].get(kernel)
                    and rec["bound_ms"] <= rec["pallas_chunked_ms"]):
                raise RuntimeError(f"amazon_spmm {rec['layout']}: {kernel} "
                                   f"off its plain walk or the segment path,"
                                   f" or not launched: {rec}")
            rows.append(rec)
            if (threshold, cu) == (0, 1024):
                v2 = dc
            del dc
            torch.cuda.empty_cache()
    return rows, v2


def _fullscale_uw(torch, device, ds_n, cache_dir):
    """``uw_k1_probe`` at h2048 and ``amazon_uw_fullscale`` at h512, K=8
    (1 round, then a rerun with the same key to 2) on the normalised
    synth-amazon2m-small."""
    import math

    from gist_tpu_torch.bench import amazon_uw_fullscale, uw_k1_probe
    t0 = time.time()
    probe = uw_k1_probe.run(ds_n, device, hidden=2048, steps=5, rounds=3,
                            psize=50, batch_size=10, cache_dir=cache_dir)
    del probe["params"]
    emit({"phase": "fullscale_scripts", "script": "uw_k1_probe",
          "seconds": time.time() - t0, **probe})
    if not (all(math.isfinite(v) for v in probe["losses"])
            and probe["kernel_launches"].get("K1")
            and probe["projected_round750_s"] > 0):
        raise RuntimeError(f"uw_k1_probe failed its checks: {probe}")
    ckpt = os.path.join(cache_dir, "uw_ckpt_h512_k8")
    kw = dict(hidden=512, k=8, eval_every=1, psize=50, batch_size=10,
              iter_per_site=5, ckpt=ckpt, cache_dir=cache_dir,
              verbose=False)
    calls = []
    for epochs in (8, 16):      # local epochs 1, then 2: 1 round, then 2
        t0 = time.time()
        rec = amazon_uw_fullscale.run(ds_n, device, epochs=epochs,
                                      eval_on_cpu=False, **kw)
        rec["seconds"] = time.time() - t0
        emit({"phase": "fullscale_scripts", "script": "amazon_uw_fullscale",
              **rec})
        calls.append(rec)
    first, second = calls
    if not (first["n_rounds"] == 1 and first["resumed_from_round"] == 0
            and second["n_rounds"] == 2
            and second["resumed_from_round"] == 1
            and second["rounds_this_call"] == 1
            and second["losses"][0] == first["losses"][0]
            and second["val_accs"][0] == first["val_accs"][0]
            and all(math.isfinite(v) for v in second["losses"])
            and first["kernel_launches"].get("K1")
            and second["kernel_launches"].get("K1")):
        raise RuntimeError(f"amazon_uw_fullscale's rerun did not resume "
                           f"from its checkpoint: {calls}")
    return probe, calls


def _fullscale_cluster(torch, cache_dir):
    """``cluster_fullscale`` for 1 epoch on synth-amazon2m-small (psize
    50) against ``train_cluster_gcn`` with the same config and seed."""
    from gist_tpu_torch.bench import cluster_fullscale
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.models import sage
    from gist_tpu_torch.train.cluster import train_cluster_gcn
    from gist_tpu_torch.train.common import TrainConfig
    t0 = time.time()
    rec = cluster_fullscale.run(dataset="synth-amazon2m-small", n_epochs=1,
                                eval_every=1, psize=50, batch_size=10,
                                cache_dir=cache_dir, device="cuda",
                                eval_cpu=False)
    cli_s = time.time() - t0
    ds = load_dataset("synth-amazon2m-small")
    cfg = sage.SAGEConfig(ds.in_feats, 512, ds.n_classes, n_layers=4,
                          dropout=0.2, use_layernorm=True)
    tc = TrainConfig(lr=0.01, weight_decay=0.0, n_epochs=1, seed=3)
    direct = train_cluster_gcn(ds, cfg, tc, psize=50, batch_size=10,
                               use_f1=True, normalize=True,
                               cache_dir=cache_dir, eval_cpu=False,
                               eval_every=1, scan_batches=True,
                               device="cuda")
    rel = _loss_rel(rec["losses"], direct["losses"])
    row = {"phase": "fullscale_scripts", "script": "cluster_fullscale",
           "seconds": cli_s, "losses": rec["losses"],
           "direct_losses": direct["losses"], "loss_rel": rel,
           "val_accs": rec["val_accs"], "direct_val_accs":
           direct["val_accs"], "steady_epoch_s": rec.get("steady_epoch_s"),
           "hardware": rec["hardware"], "power_limit_w":
           rec["power_limit_w"], "kernel_launches": rec["kernel_launches"],
           "tol": FULLSCALE_TOL}
    emit(row)
    if not (rel and max(rel) <= FULLSCALE_TOL
            and rec["kernel_launches"].get("K1")):
        raise RuntimeError(f"cluster_fullscale off the direct trainer: "
                           f"{row}")
    return rec


def phase_fullscale_scripts(torch, device, ds_a, ds_big, big_graph, builds):
    """Phase 31 (see the module docstring); returns the launches by
    kernel of the whole phase, the ``amazon_spmm`` rows and the host v2
    layout at CU 1024."""
    import dataclasses
    import tempfile

    from gist_tpu_torch.bench import gat_chunked
    from gist_tpu_torch.graph import graph_from_edges
    before = launch_counts()
    g_a = graph_from_edges(ds_a.senders, ds_a.receivers,
                           ds_a.n_nodes).to(device)
    spmm_rows, v2 = _fullscale_spmm(torch, device, ds_a, g_a, builds)
    del g_a

    t0 = time.time()
    gc = gat_chunked.run(ds_big, big_graph, device, hidden=128, heads=2,
                         iters=3)
    emit({"phase": "fullscale_scripts", "script": "gat_chunked",
          "seconds": time.time() - t0, **gc})
    if not (gc["zero_score_rel_err_vs_spmm"] <= FULLSCALE_TOL
            and gc["logits_finite"]
            and gc["kernel_launches"].get("K4")
            and gc["kernel_launches"].get("K1")):
        raise RuntimeError(f"gat_chunked failed its checks: {gc}")
    torch.cuda.empty_cache()

    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_fullscale_")
    try:
        ds_n = dataclasses.replace(ds_a)
        ds_n.normalize_features()
        _fullscale_uw(torch, device, ds_n, cache_dir)
        _fullscale_cluster(torch, cache_dir)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    launches = {k: launch_counts()[k] - before[k] for k in before}
    emit({"phase": "fullscale_scripts", "launches": launches,
          "k1_cu_rows": {r["layout"]: r["plain_rel_err"]
                         for r in spmm_rows}})
    torch.cuda.empty_cache()
    return launches, spmm_rows, v2


# --- remaining_scripts: the projection, record_r2 and the cost models ------

# Phase 32's cut of record_r2: its reddit-small full-graph SAGE fp32 run
# at 3 of 60 epochs (K1), and the ultra-wide point h64 K=2 at 2 epochs
# (one round of 150 steps a subnet); each against the trainer called
# directly with the same configuration and seeds.  The full-graph run is
# held at 1e-5 relative.  The ultra-wide point's batches (~4,000 edges)
# are under TILES_MIN_EDGES and take the segment path, S1, which sums in
# a fixed order: its record must equal the direct call's bit for bit
# (with atomics it read 8.1e-6 off, and K1 was forced to carry it).
R2_SINGLE, R2_SINGLE_EPOCHS = "reddit_full_float32", 3
R2_UW, R2_UW_EPOCHS, R2_UW_PSIZE = "ultrawide:64,2", 2, 1500
R2_TOL = 1e-5


def _r2_against_direct(torch, what, name, n_epochs, out_dir, cache_dir):
    """``record_r2`` for the run ``name`` of ``what`` at ``n_epochs``, and
    the same run's trainer called directly, both on the partitions cached
    in ``cache_dir``: (record, direct result)."""
    import dataclasses

    from gist_tpu_torch.bench import record_r2
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.train.full_graph import train_full_graph
    from gist_tpu_torch.train.ist_ultrawide import train_ist_ultrawide
    rec = record_r2.record(what, "cuda", only=[name], n_epochs=n_epochs,
                           out_dir=out_dir, cache_dir=cache_dir)[name]
    t0 = time.time()
    run = next(r for r in record_r2.runs(what) if r.name == name)
    ds = dataclasses.replace(load_dataset(run.dataset))
    if run.normalize:
        ds.normalize_features()
    model, cfg, tc = record_r2.configs(run, ds, n_epochs)
    if run.trainer == "full_graph":
        direct = train_full_graph(ds, cfg, tc, model=model, device="cuda",
                                  verbose=False, **run.kw)
    else:
        direct = train_ist_ultrawide(ds, cfg, tc, model=model,
                                     sequential=True, device="cuda",
                                     verbose=False, cache_dir=cache_dir,
                                     **run.kw)
    direct["wall_time"] = time.time() - t0
    return rec, direct


def phase_remaining_scripts(torch, ds_a, v2_layout, ring, dev, builds):
    """Phase 32 (see the module docstring); returns the launches by kernel
    of the scripts' own runs.  ``builds`` (:class:`HostBuilds`) holds the
    cost models' counts and the ultra-wide point's partitions."""
    import tempfile

    from gist_tpu_torch.bench import (amazon_split_analysis,
                                      amazon_tn_analysis,
                                      scaling_projection)
    from gist_tpu_torch.data import load_dataset
    launches = dict.fromkeys(launch_counts(), 0)

    def add(got):
        for k, v in got.items():
            launches[k] += v

    t0 = time.time()
    link = (f"gloo via host, {ring['ranks']} ranks on one {dev['name']} "
            f"(phase 27's ring exchange of F=602 fp32 halo rows, beside "
            f"phase 29's 4-rank world)")
    proj = scaling_projection.run(
        load_dataset("synth-reddit-small"), "cuda",
        link_bytes_per_s=ring["bytes_per_s"], link_name=link,
        devices=(2, 4), iters=5)
    add(proj["kernel_launches"])
    emit({"phase": "remaining_scripts", "script": "scaling_projection",
          "seconds": time.time() - t0, "ring_rate": ring, **proj})
    effs = [p[k] for p in proj["projections"] for k in (
        "efficiency_overlap_fp32", "efficiency_serial_fp32",
        "efficiency_overlap_bf16")]
    if not (proj["kernel_launches"].get("K1")
            and proj["t1_source"].startswith("K1 forward")
            and proj["t1_agg_ms_fp32"] > 0 and proj["t1_agg_ms_bf16"] > 0
            and all(0 < e <= 1.0 + 1e-9 for e in effs)):
        raise RuntimeError(f"scaling_projection failed its checks: {proj}")

    rows = {}
    parts = builds.get(torch, "r2_partitions")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_r2_") as out_dir:
        for what, name, epochs in (
                ("singles", R2_SINGLE, R2_SINGLE_EPOCHS),
                (R2_UW, "uw_h64_k2", R2_UW_EPOCHS)):
            t0 = time.time()
            rec, direct = _r2_against_direct(torch, what, name, epochs,
                                             out_dir, parts["cache_dir"])
            add(rec["kernel_launches"])
            rel = _loss_rel(rec["losses"], direct["losses"])
            rows[name] = row = {
                "phase": "remaining_scripts", "script": "record_r2",
                "run": name, "epochs": epochs, "seconds": time.time() - t0,
                "wall_time": rec["wall_time"],
                "direct_wall_time": direct["wall_time"],
                "losses": rec["losses"],
                "direct_losses": direct["losses"], "loss_rel": rel,
                "tol": R2_TOL if what != R2_UW else "bitwise",
                "losses_equal": rec["losses"] == direct["losses"],
                "kernel_launches": rec["kernel_launches"],
                "file": os.path.basename(os.path.join(
                    out_dir, f"torch_r2_{name}.json")),
                "written": os.path.exists(os.path.join(
                    out_dir, f"torch_r2_{name}.json")),
                **{k: rec[k] for k in ("best_val_acc", "best_val",
                                       "mean_epoch_s", "train_time",
                                       "hardware", "power_limit_w")
                   if k in rec}}
            emit(row)
    for name, row in rows.items():
        if not (row["written"] and row["loss_rel"]
                and max(row["loss_rel"]) <= R2_TOL):
            raise RuntimeError(f"record_r2 {name} off the trainer called "
                               f"directly: {row}")
    uw = rows["uw_h64_k2"]
    if not uw["losses_equal"]:
        raise RuntimeError(f"record_r2's ultra-wide point is not the "
                           f"trainer's run bit for bit: {uw}")
    if not (rows[R2_SINGLE]["kernel_launches"].get("K1")
            and uw["kernel_launches"].get("S1")
            and not uw["kernel_launches"].get("K1")):
        raise RuntimeError("record_r2: the full-graph run did not launch "
                           "K1, or the ultra-wide point left the segment "
                           "path")

    # the counts (host numpy) came from the host builds; the rates are
    # this card's, measured here, and the walls follow from both
    t0 = time.time()
    counts = builds.get(torch, "cost_counts")
    rates = amazon_split_analysis.measure_rates(ds_a.n_nodes, v2_layout,
                                                "cuda")
    kw = {k: rates[k] for k in ("gather_rows_per_s", "stream_bytes_per_s",
                                "permute_s")}
    pairs, slots, split_rows = counts["split"]
    e = len(ds_a.senders)
    for row in split_rows:
        row.update(amazon_split_analysis.split_wall(row, 64, e, **kw))
    tn_rows = counts["tn"]
    for row in tn_rows:
        row.update(amazon_tn_analysis.tn_wall(
            row, e, budget_gib=rates["budget_gib"], **kw))
    emit({"phase": "remaining_scripts", "script": "cost_models",
          "seconds": time.time() - t0, "counts_s": counts["seconds"],
          "rates": rates, "split_pairs": pairs, "split_unique_slots": slots,
          "split_rows": split_rows, "tn_rows": tn_rows})
    walls = [r["t_total_ms"] for r in split_rows + tn_rows]
    if not (all(rates[k] > 0 for k in amazon_split_analysis.SOURCE_KEYS)
            and all(w > 0 for w in walls)
            and slots == tn_rows[0]["slots"]):
        raise RuntimeError(f"the cost models failed their checks: {rates}")
    return launches


def _stop_resource_tracker():
    """Stop the ``spawn`` context's resource tracker, which phases 27-29's
    ``torch.multiprocessing`` started and which would live until this
    process exits."""
    from multiprocessing import resource_tracker
    tracker = resource_tracker._resource_tracker
    if tracker._pid is not None:          # started by a spawn
        tracker._stop()


def _chunked_by_cu(rows, kernel):
    """Phase 31's ``amazon_spmm`` rows of ``kernel`` by layout: the pass's
    ms, bound, the segment path's ms and both errors."""
    return {r["layout"]: {k: r[k] for k in (
        "pallas_chunked_ms", "bound_ms", "bound_by", "segment_chunked_ms",
        "plain_rel_err", "rel_err_vs_segment", "n_chunks")}
        for r in rows if r["kernel"] == kernel}


def phase_processes():
    """Every process this script started must have ended: wait up to 10 s
    for them, print what is left, and fail (after killing it) if any
    is."""
    _stop_resource_tracker()
    deadline = time.time() + 10
    left = procs.descendants()
    while left and time.time() < deadline:
        time.sleep(0.5)
        left = procs.descendants()
    emit({"phase": "processes", "left": [{"pid": pid, "cmd": cmd[:200]}
                                         for pid, cmd in left]})
    if left:
        procs.kill([pid for pid, _ in left])
        raise RuntimeError(f"processes left running: {left}")


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_all = time.time()

    t0 = time.time()
    dev = phase_device(torch)
    emit({"phase": "device", **dev, "seconds": time.time() - t0})

    emit({"phase": "build", "seconds": phase_build()})
    # the host builds of phases 10, 12 and 31 run beside the phases
    # before them
    builds = HostBuilds(os.path.join(HERE, "scratch_chip",
                                     f"host_builds.{os.getpid()}"))

    t0 = time.time()
    bench_launches, k1_tiles = phase_bench(torch, device, dev)
    emit({"phase": "bench", "seconds": time.time() - t0})

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
    sim_s1 = phase_ist_simulation(torch)
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
        ((512, torch.float32), (41, torch.float32)), plain_reps=1)
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
    s1_shapes = _s1_shapes(torch, device, ds, ds_r)
    s1_plans, s1_probe = phase_s1_plans(torch, s1_shapes)
    emit({"phase": "s1_plans", "seconds": time.time() - t0})

    t0 = time.time()
    s1_rows, s1_launches = phase_segment_csr(torch, s1_shapes, ds, ds_r)
    del s1_shapes
    torch.cuda.empty_cache()
    emit({"phase": "segment_csr", "seconds": time.time() - t0})

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
    split_rows, split_pair = phase_split_kernels(torch, device, g_amazon,
                                                 builds)
    emit({"phase": "split_kernels", "seconds": time.time() - t0})

    t0 = time.time()
    k2_launches = phase_split_path(torch, device, ds, g_amazon, split_pair)
    emit({"phase": "split_path", "seconds": time.time() - t0})
    del g_amazon, split_pair
    torch.cuda.empty_cache()

    t0 = time.time()
    full = builds.get(torch, "full_graph")
    ds_big = full["ds"]
    build = {k: full[k] for k in ("dataset_s", "layout_build_s")}
    build.update(waited_s=builds.waited["full_graph"],
                 load_s=time.time() - t0)
    full_launches, big_graph, chunked_rows = phase_full_path(
        torch, device, ds_big, full.pop("graph"), build)
    emit({"phase": "full_path", "seconds": time.time() - t0})

    t0 = time.time()
    chunked_k4 = phase_gat_chunked(torch, device, ds_big, big_graph)
    emit({"phase": "gat_chunked", "seconds": time.time() - t0})

    t0 = time.time()
    scan_c_launches, scan_c_row = phase_scan_epochs_chunked(
        torch, device, ds_big, big_graph)
    emit({"phase": "scan_epochs_chunked", "seconds": time.time() - t0})

    t0 = time.time()
    fullscale_launches, fullscale_spmm, v2_layout = phase_fullscale_scripts(
        torch, device, ds, ds_big, big_graph, builds)
    emit({"phase": "fullscale_scripts", "seconds": time.time() - t0})
    del ds_big, big_graph
    torch.cuda.empty_cache()

    t0 = time.time()
    multi, k1_interior, ring = phase_multi_rank(torch, dev["power"])
    emit({"phase": "multi_rank", "seconds": time.time() - t0})
    sharded_launches, mesh_launches = multi["sharded_graph"], \
        multi["ist_mesh"]
    ist_2d_launches = multi["ist_sharded_2d"]["K1"]

    t0 = time.time()
    remaining_launches = phase_remaining_scripts(torch, ds, v2_layout, ring,
                                                 dev, builds)
    emit({"phase": "remaining_scripts", "seconds": time.time() - t0})
    del v2_layout

    t0 = time.time()
    cli_launches = phase_uw_cli_chunked_eval(torch, device, builds)
    emit({"phase": "uw_cli_chunked_eval", "seconds": time.time() - t0})
    builds.close()
    emit({"phase": "host_builds", "waited_s": builds.waited})

    phase_processes()

    main_case = cases["fwd F=256 float32"]
    full_case = chunked_rows["run_dedup_chunked fwd F=256 float32"]
    kernels = [{
        "name": "dedup_spmm", "route": "cuda",
        "source": "gist_tpu_torch/csrc/dedup_spmm.cu",
        "replaces": "gist_tpu/ops/pallas_spmm.py:66",
        "launches": launches + full_launches + resume_launches
        + cli_launches + pp_launches + lsgd_launches + ic_gcn_launches
        + uw_gcn_launches + scan_b_launches + scan_c_launches
        + sharded_launches["K1"] + mesh_launches["K1"] + ist_2d_launches
        + bench_launches["K1"] + fullscale_launches["K1"]
        + remaining_launches["K1"],
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
                             "ist_sharded_2d": ist_2d_launches,
                             "bench": bench_launches["K1"],
                             "fullscale_scripts": fullscale_launches["K1"],
                             "remaining_scripts":
                                 remaining_launches["K1"]},
        "replay_rel_err": max([r["rel_err"] for r in scan_b_rows.values()]
                              + [scan_c_row["rel_err"]]),
        "max_abs_err": max([c["max_abs_err"] for c in [
            *cases.values(), *chunked_rows.values(), *lsgd_k1.values(),
            *gcn_k1.values()] if c["case"].endswith("float32")]
            + [r["max_abs_err"] for r in k1_interior.values()]
            + [r["max_abs_err"] for r in k1_tiles
               if r["dtype"] == "fp32"]
            + [r["plain_max_abs_err"] for r in fullscale_spmm
               if r["kernel"] == "K1"]),
        "sharded_interior": k1_interior,
        "tile_sizes": {f"TN={r['tile_rows']} {r['dtype']}": {
            k: r[k] for k in ("ms", "bound_ms", "bound_by", "max_abs_err",
                              "rel_err", "bitwise_repeat")}
            for r in k1_tiles},
        "ms": main_case["ms"], "call_ms": main_case["call_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "full_scale_pass": {k: full_case[k] for k in (
            "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "chunked_by_cu": _chunked_by_cu(fullscale_spmm, "K1")}]
    gat_kernels = (("K4", "gat_fwd", "gist_tpu/ops/pallas_gat.py:546"),
                   ("K5", "gat_bwd_b1", "gist_tpu/ops/pallas_gat.py:1015"),
                   ("K6", "gat_bwd_b2", "gist_tpu/ops/pallas_gat.py:1070"))
    split_main = split_rows["fwd CU=1024 F=100 float32"]
    kernels.append({
        "name": "split_spmm", "route": "cuda",
        "source": "gist_tpu_torch/csrc/split_spmm.cu",
        "replaces": "gist_tpu/ops/pallas_spmm.py:298",
        "launches": k2_launches + fullscale_launches["K2"],
        "launches_by_path": {"split_gcn_step": k2_launches,
                             "fullscale_scripts": fullscale_launches["K2"]},
        "max_abs_err": max([c["max_abs_err"] for c in split_rows.values()
                            if c["case"].endswith("float32")]
                           + [r["plain_max_abs_err"] for r in fullscale_spmm
                              if r["kernel"] == "K2"]),
        "chunked_by_cu": _chunked_by_cu(fullscale_spmm, "K2"),
        "ms": split_main["ms"], "call_ms": split_main["call_ms"],
        "plain_ms": split_main["plain_ms"],
        "bound_ms": split_main["bound_ms"],
        "bound_by": split_main["bound_by"],
        "library_ms": split_main["library_ms"]})
    for (key, name, replaces), count in zip(gat_kernels, gat_launches):
        main_row = gat_rows[(key, "H=2 O=256 float32")]
        extra = chunked_k4 if key == "K4" else 0
        scripts = fullscale_launches[key]
        sharded = sharded_launches["K4"] if key == "K4" else 0
        kernels.append({
            "name": name, "route": "cuda",
            "source": "gist_tpu_torch/csrc/gat_dedup.cu",
            "replaces": replaces,
            "launches": count + extra + sharded + mesh_launches[key]
            + bench_launches[key] + scripts,
            "launches_by_path": {"gat_gist": count,
                                 "gat_gist_mesh": mesh_launches[key],
                                 "bench": bench_launches[key],
                                 "fullscale_scripts": scripts,
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
            "launches": v1_launches[key] + scan_v1_launches[key]
            + bench_launches[key],
            "launches_by_path": {path: v1_launches[key],
                                 scan_path: scan_v1_launches[key],
                                 "bench": bench_launches[key]},
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
    s1_main = s1_rows["batch fwd F=256 float32"]
    s1_by_path = {**s1_launches, "ist_simulation": sim_s1,
                  "sharded_graph": sharded_launches["S1"],
                  "ist_sharded_2d": multi["ist_sharded_2d"]["S1"],
                  "bench": bench_launches["S1"],
                  "remaining_scripts": remaining_launches["S1"]}
    kernels.append({
        "name": "segment_csr", "route": "cuda",
        "source": "gist_tpu_torch/csrc/segment_csr.cu",
        "replaces": "no TPU kernel: XLA's segment_sum in "
                    "gist_tpu/ops/spmm.py:84, gist_tpu/ops/segment.py:64, "
                    ":86",
        "launches": sum(s1_by_path.values()),
        "launches_by_path": s1_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in s1_rows.values()
                           if r["case"].endswith("float32")),
        "bitwise_repeat": all(r["bitwise_repeat"] for r in s1_rows.values()),
        "state": "redesigned for the H100: 16- or 8-byte vectors by row "
                 "alignment, gathers in flight, column bands past a wave",
        **{k: s1_main[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "library_csr_ms",
                                   "library_det_ms", "gathered_tb_s")},
        "shapes": {case: {k: r[k] for k in (
            "plan", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "library_csr_ms", "library_ms", "library_det_ms",
            "gathered_bytes", "gathered_tb_s", "max_abs_err", "rel_err",
            "bitwise_repeat")} for case, r in s1_rows.items()},
        "plans": {r["case"]: {k: r[k] for k in (
            "chosen", "chosen_ms", "best", "best_ms")} for r in s1_plans},
        "latency_probe": s1_probe})
    emit({"kernels": kernels})
    emit({"phase": "total", "seconds": time.time() - t_all})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})


if __name__ == "__main__":
    main()
