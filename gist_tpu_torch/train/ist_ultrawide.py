"""Ultra-wide IST trainer (``gist_tpu/train/ist_ultrawide.py:
train_ist_ultrawide``): the full-width model lives in host RAM as
numpy; a device holds only 1/K-width sub-models.  Sequential mode
trains the K subnets of a round one after another on one device; mesh
mode (``sequential=False``) trains them one a rank of a ``subnet`` mesh
of K ranks and gathers the trained shards over it, every rank then
merging them into its host copy.  In mesh mode every rank runs the
sampler, the partition draws and the merge; rank 0 evaluates and saves,
and every rank returns rank 0's results.  Each process holds its own
copy of the dataset and of the full-width params.

With ``checkpoint_dir`` every eval round saves the params, the round
and the dropout generator's state (:mod:`gist_tpu_torch.train.
checkpoint`) and rewrites ``progress.json``, the partial result record;
a rerun with the same arguments resumes after the newest round,
replaying the partition draws and the batch stream the finished rounds
consumed, and reproduces the uninterrupted run.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from gist_tpu_torch.convert import params_from_jax, params_to_numpy
from gist_tpu_torch.data.container import Dataset
from gist_tpu_torch.graph import graph_from_edges
from gist_tpu_torch.ist.partition import boundary_sizes
from gist_tpu_torch.ist.distributed import make_subnet_mesh
from gist_tpu_torch.ist.ultrawide import (build_local_burst,
                                          build_local_burst_single,
                                          dispatch_host, merge_host,
                                          sample_boundaries_host,
                                          shard_over_subnets,
                                          subnet_generator)
from gist_tpu_torch.models import gat, sage
from gist_tpu_torch.models.common import micro_f1
from gist_tpu_torch.parallel import comm
from gist_tpu_torch.sampler import ClusterSampler
from gist_tpu_torch.train.checkpoint import (generator_state,
                                             latest_round_dir,
                                             load_checkpoint,
                                             params_to_host,
                                             restore_generator,
                                             save_checkpoint)
from gist_tpu_torch.train.common import TrainConfig
from gist_tpu_torch.train.ist_cluster import (_batches_to_device,
                                              _RoundCollector, check_kind)
from gist_tpu_torch.utils import draw_seed, resolve_device

# Above this many activation elements (nodes x hidden width) the eval on
# the CPU takes the chunked host forward (sage.apply_chunked_host): the
# plain forward's N x 2h fp32 concat would not fit comfortably in RAM.
CHUNKED_EVAL_MIN_ELEMENTS = 2 ** 28


def train_ist_ultrawide(
    ds: Dataset,
    model_cfg: sage.SAGEConfig,
    tc: TrainConfig,
    *,
    psize: int = 1500,
    batch_size: int = 20,
    use_pp: bool = False,
    use_f1: bool = False,
    normalize: bool = False,
    cache_dir: Optional[str] = None,
    model=sage,
    kind: str = "sage",
    mesh=None,
    eval_on_cpu: bool = True,
    eval_every_rounds: int = 1,
    checkpoint_dir: Optional[str] = None,
    sequential: Optional[bool] = None,
    init_params: Optional[dict] = None,
    device="cuda",
    verbose: bool = True,
) -> dict:
    """Train ``model`` (``sage`` with kind "sage", ``gcn`` with kind
    "gcn") with ultra-wide GIST on ``device``.

    ``sequential=False`` (or a ``mesh``) trains over a ``subnet`` mesh
    of K ranks (``mesh`` defaults to one over the initialised process
    group); ``sequential=None`` means sequential unless a mesh is
    given.  Subnet s draws its dropout from stream s of the round's seed
    in both modes, so they train the same model.  ``use_pp`` hands
    the model precomputed first-layer features (SAGE with a ``use_pp``
    config).  ``init_params`` (a numpy parameter tree, e.g. the JAX
    package's ``init`` output) replaces the seeded initialisation.  The
    full-graph eval runs on the CPU when ``eval_on_cpu``, for SAGE
    through the chunked host forward above ``CHUNKED_EVAL_MIN_ELEMENTS``
    activation elements, else on ``device``.

    GAT has no ultra-wide mode: the JAX trainer builds every sub-config
    with ``split_input``/``split_output``, which ``GATConfig.sub_config``
    does not take, so ``model=gat`` raises there too."""
    if kind not in ("sage", "gcn") or model is gat:
        raise ValueError(
            "the ultra-wide trainer trains SAGE or GCN (kind 'sage' or "
            "'gcn'): the JAX trainer has no GAT path, its GATConfig."
            "sub_config takes no split_input/split_output")
    check_kind(model, kind)
    dev = resolve_device(device)
    K = tc.num_subnet
    if sequential is None:
        sequential = mesh is None
    if not sequential:
        mesh = mesh or make_subnet_mesh(K, device)
        if mesh.device_type != torch.device(device).type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the run "
                             f"asks for {device}")
        dev = comm.mesh_device(mesh)
    rank0 = sequential or mesh.get_local_rank("subnet") == 0
    eval_dev = torch.device("cpu") if eval_on_cpu else dev
    if normalize:
        ds.normalize_features()
    sampler = ClusterSampler(ds, psize, batch_size, use_pp=use_pp,
                             cache_dir=cache_dir, seed=tc.seed)

    if init_params is None:
        init_params = params_to_numpy(
            model.init(torch.Generator().manual_seed(tc.seed), model_cfg))
    # full-width params: host numpy, updated in place by merge_host
    full_params = {"layers": [
        {k: np.array(v, dtype=np.float32, copy=True) for k, v in l.items()}
        for l in init_params["layers"]]}
    sub_cfg = model_cfg.sub_config(split_input=False, split_output=True,
                                   num_subnet=K)
    sizes = boundary_sizes(model_cfg.in_feats, model_cfg.n_hidden,
                           model_cfg.n_layers, split_input=False,
                           split_output=True)
    if sequential:
        burst_fn = build_local_burst_single(model, sub_cfg,
                                            weight_decay=tc.weight_decay)
    else:
        burst_fn = build_local_burst(model, sub_cfg, mesh=mesh,
                                     weight_decay=tc.weight_decay)

    chunked_eval = (kind == "sage" and eval_on_cpu
                    and ds.n_nodes * model_cfg.n_hidden
                    > CHUNKED_EVAL_MIN_ELEMENTS)
    eval_data = {}

    def evaluate(params_np):
        """(val, test); under a mesh rank 0's, handed to every rank."""
        if sequential:
            return _evaluate(params_np)
        return comm.broadcast_object(
            _evaluate(params_np) if rank0 else None, src=0,
            group=mesh.get_group("subnet"))

    def _evaluate(params_np):
        if chunked_eval:
            l = sage.apply_chunked_host(params_np, ds.senders, ds.receivers,
                                        ds.features, model_cfg)
        else:
            if not eval_data:
                eval_data["g"] = graph_from_edges(
                    ds.senders, ds.receivers, ds.n_nodes).to(eval_dev)
                eval_data["x"] = torch.from_numpy(ds.features).to(eval_dev)
            with torch.no_grad():
                logits = model.apply(params_from_jax(params_np, eval_dev),
                                     eval_data["g"], eval_data["x"],
                                     model_cfg)
            l = logits.cpu().numpy()
        if use_f1:
            return (micro_f1(l, ds.labels, ds.val_mask),
                    micro_f1(l, ds.labels, ds.test_mask))
        pred = l.argmax(-1)
        va = float((pred[ds.val_mask] == ds.labels[ds.val_mask]).mean())
        ta = float((pred[ds.test_mask] == ds.labels[ds.test_mask]).mean()) \
            if ds.test_mask.any() else va
        return va, ta

    local_epochs = max(tc.n_epochs // K, 1)
    n_rounds = max(local_epochs * len(sampler) // tc.iter_per_site, 1)
    collector = _RoundCollector(sampler, tc.iter_per_site, ids_only=True)
    tables = sampler.tables(dev)
    host_rng = np.random.default_rng(tc.seed + 1)
    generator = torch.Generator(device=dev).manual_seed(tc.dropout_seed)

    start_round = 0
    if checkpoint_dir:
        ck = latest_round_dir(checkpoint_dir)
        if ck is not None:
            state = load_checkpoint(ck)
            full_params = params_to_host(state["params"])
            restore_generator(generator, state["drop_gen"])
            start_round = int(state["round"]) + 1
            # replay the randomness the finished rounds consumed (the
            # partition draws and the cluster order), so the sequence
            # continues unchanged; the replayed batches stay on the host
            for _ in range(start_round):
                sample_boundaries_host(host_rng, sizes, K)
                collector.collect()
            if verbose:
                print(f"resumed from {ck} (round {start_round})",
                      flush=True)

    total_time = 0.0
    val_accs, test_accs, losses = [], [], []
    round_wall, host_prep, device_sync = [], [], []
    eval_rounds, train_time_at_eval, eval_wall = [], [], []
    edges_per_batch = []
    # per-round 1-min load average and peak RSS, so round-wall drift
    # can be told apart from a concurrent job on the host
    loadavg_1m, rss_gb = [], []

    def _sysstat():
        import resource
        loadavg_1m.append(round(os.getloadavg()[0], 2))
        rss_gb.append(round(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20, 2))

    def collect():
        batches = collector.collect()
        edges_per_batch.extend(b.n_real_edges for b in batches)
        return _batches_to_device(batches, dev)

    def _do_eval(rnd):
        te0 = time.time()
        va, ta = evaluate(full_params)
        eval_wall.append(time.time() - te0)
        eval_rounds.append(rnd)
        train_time_at_eval.append(total_time)
        val_accs.append(va)
        test_accs.append(ta)
        if verbose and rank0:
            print(f"round {rnd}/{n_rounds}: loss {losses[-1]:.4f} "
                  f"val {va:.4f}", flush=True)
        if not checkpoint_dir or not rank0:
            return
        save_checkpoint(os.path.join(checkpoint_dir, f"round_{rnd}"),
                        {"params": full_params, "round": rnd,
                         "drop_gen": generator_state(generator)})
        # the partial record: a run cut later still leaves its curve and
        # timing on disk (written whole, then renamed)
        part = {
            "partial": True, "round": rnd, "n_rounds": n_rounds,
            "dataset": ds.name, "num_subnet": K,
            "train_time": total_time, "val_accs": val_accs,
            "test_accs": test_accs, "losses": losses,
            "round_wall_s": round_wall, "host_prep_s": host_prep,
            "device_sync_s": device_sync, "eval_rounds": eval_rounds,
            "train_time_at_eval": train_time_at_eval,
            "eval_wall_s": eval_wall,
            "loadavg_1m": loadavg_1m, "rss_gb": rss_gb,
        }
        pp = os.path.join(checkpoint_dir, "progress.json")
        with open(pp + ".tmp", "w") as f:
            json.dump(part, f)
        os.replace(pp + ".tmp", pp)

    if start_round >= n_rounds:
        # a finished run's checkpoint: evaluate it only
        va, ta = evaluate(full_params)
        val_accs.append(va)
        test_accs.append(ta)
        losses.append(float("nan"))
    else:
        batches = collect()
    next_batches = None
    for rnd in range(start_round, n_rounds):
        t0 = time.time()
        bnds = sample_boundaries_host(host_rng, sizes, K)
        seed = draw_seed(generator)
        shards_np = dispatch_host(full_params, bnds, K, kind)
        t1 = time.time()
        t_prep = 0.0

        def prep_next():
            # the next round's host-side batch build; in sequential mode
            # it overlaps subnet 0's burst, which the device still runs
            nonlocal next_batches, t_prep
            if rnd + 1 < n_rounds:
                tp = time.time()
                next_batches = collect()
                t_prep = time.time() - tp

        if sequential:
            trained_list, loss_list = [], []
            for s in range(K):
                sub = {"layers": [
                    {k: torch.tensor(v[s], device=dev) for k, v in l.items()}
                    for l in shards_np["layers"]]}
                sub, rl = burst_fn(sub, batches, tc.lr,
                                   subnet_generator(seed, s, dev), tables)
                if s == 0:
                    prep_next()
                trained_list.append(params_to_numpy(sub))
                loss_list.append(rl.cpu().numpy())
            trained = {"layers": [
                {k: np.stack([t["layers"][i][k] for t in trained_list])
                 for k in layer}
                for i, layer in enumerate(full_params["layers"])]}
        else:
            stacked, rl = burst_fn(shard_over_subnets(mesh, shards_np),
                                   batches, tc.lr, seed, tables)
            trained, loss_list = params_to_numpy(stacked), rl.cpu().numpy()
            prep_next()
        t3 = time.time()
        full_params = merge_host(full_params, bnds, trained, K, kind)
        if rnd + 1 < n_rounds:
            batches = next_batches
        total_time += time.time() - t0
        round_wall.append(time.time() - t0)
        host_prep.append(t_prep)
        device_sync.append(t3 - t1 - t_prep)
        losses.append(float(np.mean(np.asarray(loss_list))))
        _sysstat()
        if (rnd + 1) % eval_every_rounds == 0 or rnd == n_rounds - 1:
            _do_eval(rnd)

    results = {
        "dataset": ds.name, "num_subnet": K, "train_time": total_time,
        "last_val": val_accs[-1], "best_val": max(val_accs),
        "last_test": test_accs[-1], "best_test": max(test_accs),
        "val_accs": val_accs, "test_accs": test_accs, "losses": losses,
        "ultra_wide": True,
        "round_wall_s": round_wall, "host_prep_s": host_prep,
        "device_sync_s": device_sync,
        "eval_rounds": eval_rounds,
        "train_time_at_eval": train_time_at_eval,
        "eval_wall_s": eval_wall,
        "loadavg_1m": loadavg_1m, "rss_gb": rss_gb,
        "edges_per_batch": edges_per_batch,
    }
    if verbose and rank0:
        print(f"Training Time: {total_time:.4f}", flush=True)
        print(f"Last Val: {val_accs[-1]:.4f}", flush=True)
        print(f"Best Val: {max(val_accs):.4f}", flush=True)
        print(f"Last Test: {test_accs[-1]:.4f}", flush=True)
        print(f"Best Test: {max(test_accs):.4f}", flush=True)
    return results
