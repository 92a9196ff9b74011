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
   batch 4), with times beside the segment composite's;
8. GAT reference: gradients and three training steps of a GAT
   sub-model (width 256, 2 heads, 2 layers) through K4-K6 and through
   the segment path must agree;
9. GAT main path: ``train_ist_cluster`` with GAT h512, 2 heads, K=2,
   2 layers, 2 rounds x 2 subnets x 4 steps, counting K4-K6 launches.

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
    from gist_tpu_torch.ops import dedup_spmm, gat_dedup
    builders = [dedup_spmm, gat_dedup]
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


def _layout_bytes(layout):
    """W of the real jobs, their slots and the tile offsets."""
    jobs = int(layout.job_offsets[-1])
    return (jobs * layout.tile_rows * layout.cu + jobs * layout.cu * 4
            + layout.job_offsets.numel() * 4)


def _nnz(torch, layout):
    return int(torch.count_nonzero(
        layout.w_blocks[:int(layout.job_offsets[-1])]))


def _gat_row(torch, name, case, got, want, tol, kernel, plain, segment,
             nbytes, flops, dtype):
    """Time a GAT kernel beside its plain version and the segment
    composite; raise unless every output is finite and within ``tol`` of
    the plain result relative to its max."""
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
           "ms": _median_ms(torch, kernel, reps=20),
           "plain_ms": _median_ms(torch, plain, reps=3),
           "segment_ms": _median_ms(torch, segment, reps=10),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_bytes": nbytes, "useful_flops": flops}
    emit(row)
    if not rel_err <= tol:
        raise RuntimeError(f"{name} disagrees with its plain version: {row}")
    return row


def phase_gat_kernels(torch, device, sampler):
    """K4 at (H=2, O=256) and (H=1, O=41), K5 and K6 for one head at
    O=256 and O=41, in fp32, and all three in bf16 at O=256, on one
    batch of the GAT main path.  ``segment_ms`` is the port's segment
    composite on the same batch (K4: the attention forward; K5 and K6:
    the whole backward of one head, which both together replace); no
    single PyTorch call computes these functions."""
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
            nnz * heads * (2 * o + 6), dtype)
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
            + n * 4, nnz * (2 * o + 10), dtype)
        rows[("K6", tag)] = _gat_row(
            torch, "K6", tag, G.gat_bwd_b2(*b2_args),
            G.gat_bwd_b2_reference(*b2_args), tol_b,
            lambda: G.gat_bwd_b2(*b2_args),
            lambda: G.gat_bwd_b2_reference(*b2_args), seg_bwd,
            _layout_bytes(tt) + 2 * rt * o * item + rt * 8 + n * o * 4
            + n * 16, nnz_t * (4 * o + 10), dtype)
    return rows


def phase_gat_reference(torch, device, sampler):
    """One GAT sub-model of the main path (width 256, 2 heads, 2 layers)
    on three real batches, through K4-K6 and through the segment path:
    the first step's parameter gradients and the losses of three Adam
    steps must agree to 1e-4 relative (fp32; summation order and the
    fused backward's atomics are the only differences)."""
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
    from gist_tpu_torch.models import gat
    from gist_tpu_torch.ops import gat_dedup as G
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.ist_cluster import train_ist_cluster

    cfg = gat.GATConfig(602, 512, 41, n_layers=2, n_heads=2)
    tc = TrainConfig(lr=1e-2, weight_decay=5e-4, n_epochs=8, num_subnet=2,
                     iter_per_site=4)
    G.reset_launches()
    r = train_ist_cluster(ds, cfg, tc, psize=10, batch_size=4,
                          normalize=True, model=gat, kind="gat",
                          verbose=False, device="cuda")
    torch.cuda.synchronize()
    launches = (G.launches_fwd, G.launches_b1, G.launches_b2)
    steps = len(r["losses"]) * tc.num_subnet * tc.iter_per_site
    emit({"phase": "gat_main_path", "rounds": len(r["losses"]),
          "steps": steps, "losses": r["losses"],
          "round_wall_s": r["round_wall_s"], "train_time_s": r["train_time"],
          "edges_per_sec": r["edges_per_sec"], "val_acc": r["val_accs"],
          "test_acc": r["test_accs"], "eval_times": r["eval_times"],
          "edges_per_batch": r["edges_per_batch"],
          "launches_k4_k5_k6": list(launches)})
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

    main_case = cases["fwd F=256 float32"]
    kernels = [{
        "name": "dedup_spmm", "route": "cuda",
        "source": "gist_tpu_torch/csrc/dedup_spmm.cu",
        "replaces": "gist_tpu/ops/pallas_spmm.py:66",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()
                           if c["case"].endswith("float32")),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]
    gat_kernels = (("K4", "gat_fwd", "gist_tpu/ops/pallas_gat.py:546"),
                   ("K5", "gat_bwd_b1", "gist_tpu/ops/pallas_gat.py:1015"),
                   ("K6", "gat_bwd_b2", "gist_tpu/ops/pallas_gat.py:1070"))
    for (key, name, replaces), count in zip(gat_kernels, gat_launches):
        main_row = gat_rows[(key, "H=2 O=256 float32")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "gist_tpu_torch/csrc/gat_dedup.cu",
            "replaces": replaces, "launches": count,
            "max_abs_err": max(r["max_abs_err"] for (k, tag), r in
                               gat_rows.items()
                               if k == key and tag.endswith("float32")),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": None,
            "segment_ms": main_row["segment_ms"]})
    emit({"kernels": kernels})
    emit({"phase": "total", "seconds": time.time() - t_all})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})


if __name__ == "__main__":
    main()
