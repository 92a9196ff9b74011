"""Ultra-wide IST trainer, sequential mode
(``gist_tpu/train/ist_ultrawide.py:train_ist_ultrawide``): the
full-width model lives in host RAM as numpy; the device holds one
1/K-width sub-model at a time, and the K subnets of a round train one
after another on it.

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
from gist_tpu_torch.ist.ultrawide import (build_local_burst_single,
                                          dispatch_host, merge_host,
                                          sample_boundaries_host)
from gist_tpu_torch.models import sage
from gist_tpu_torch.models.common import micro_f1
from gist_tpu_torch.sampler import ClusterSampler
from gist_tpu_torch.train.checkpoint import (generator_state,
                                             latest_round_dir,
                                             load_checkpoint,
                                             params_to_host,
                                             restore_generator,
                                             save_checkpoint)
from gist_tpu_torch.train.common import TrainConfig
from gist_tpu_torch.train.ist_cluster import (_batches_to_device,
                                              _RoundCollector)
from gist_tpu_torch.utils import resolve_device

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
    mesh=None,
    eval_on_cpu: bool = True,
    eval_every_rounds: int = 1,
    checkpoint_dir: Optional[str] = None,
    sequential: Optional[bool] = None,
    init_params: Optional[dict] = None,
    device="cuda",
    verbose: bool = True,
) -> dict:
    """Train the SAGE stack with ultra-wide GIST on ``device``.

    Only the sequential mode is ported (``sequential`` None or True);
    the subnet mesh waits for the distributed slice, ``use_pp`` for the
    plain GraphSAGE stack.  ``init_params`` (a numpy parameter tree,
    e.g. the JAX package's ``sage.init`` output) replaces the seeded
    initialisation.  The full-graph eval runs on the CPU when
    ``eval_on_cpu``, through the chunked host forward above
    ``CHUNKED_EVAL_MIN_ELEMENTS`` activation elements, else on
    ``device``."""
    if mesh is not None or sequential is False:
        raise NotImplementedError(
            "the subnet-mesh mode of the ultra-wide trainer waits for the "
            "distributed slice of the port; use sequential=True")
    if use_pp:
        raise NotImplementedError(
            "the use_pp precomputation waits for the slice that ports the "
            "plain GraphSAGE stack")
    dev = resolve_device(device)
    eval_dev = torch.device("cpu") if eval_on_cpu else dev
    K = tc.num_subnet
    if normalize:
        ds.normalize_features()
    sampler = ClusterSampler(ds, psize, batch_size, cache_dir=cache_dir,
                             seed=tc.seed)

    if init_params is None:
        init_params = params_to_numpy(
            sage.init(torch.Generator().manual_seed(tc.seed), model_cfg))
    # full-width params: host numpy, updated in place by merge_host
    full_params = {"layers": [
        {k: np.array(v, dtype=np.float32, copy=True) for k, v in l.items()}
        for l in init_params["layers"]]}
    sub_cfg = model_cfg.sub_config(split_input=False, split_output=True,
                                   num_subnet=K)
    sizes = boundary_sizes(model_cfg.in_feats, model_cfg.n_hidden,
                           model_cfg.n_layers, split_input=False,
                           split_output=True)
    burst_fn = build_local_burst_single(sage, sub_cfg,
                                        weight_decay=tc.weight_decay)

    chunked_eval = (eval_on_cpu and ds.n_nodes * model_cfg.n_hidden
                    > CHUNKED_EVAL_MIN_ELEMENTS)
    eval_data = {}

    def evaluate(params_np):
        if chunked_eval:
            l = sage.apply_chunked_host(params_np, ds.senders, ds.receivers,
                                        ds.features, model_cfg)
        else:
            if not eval_data:
                eval_data["g"] = graph_from_edges(
                    ds.senders, ds.receivers, ds.n_nodes).to(eval_dev)
                eval_data["x"] = torch.from_numpy(ds.features).to(eval_dev)
            with torch.no_grad():
                logits = sage.apply(params_from_jax(params_np, eval_dev),
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
        if verbose:
            print(f"round {rnd}/{n_rounds}: loss {losses[-1]:.4f} "
                  f"val {va:.4f}", flush=True)
        if not checkpoint_dir:
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
    for rnd in range(start_round, n_rounds):
        t0 = time.time()
        bnds = sample_boundaries_host(host_rng, sizes, K)
        shards_np = dispatch_host(full_params, bnds, K)
        t1 = time.time()
        trained_list, loss_list, t_prep = [], [], 0.0
        for s in range(K):
            sub = {"layers": [
                {k: torch.tensor(v[s], device=dev) for k, v in l.items()}
                for l in shards_np["layers"]]}
            sub, rl = burst_fn(sub, batches, tc.lr, generator, tables)
            # the next round's host-side batch build overlaps subnet 0's
            # burst, which the device is still running
            if s == 0 and rnd + 1 < n_rounds:
                tp = time.time()
                next_batches = collect()
                t_prep = time.time() - tp
            trained_list.append(params_to_numpy(sub))
            loss_list.append(rl.cpu().numpy())
        trained = {"layers": [
            {k: np.stack([t["layers"][i][k] for t in trained_list])
             for k in layer} for i, layer in enumerate(full_params["layers"])]}
        t3 = time.time()
        full_params = merge_host(full_params, bnds, trained, K)
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
    if verbose:
        print(f"Training Time: {total_time:.4f}", flush=True)
        print(f"Last Val: {val_accs[-1]:.4f}", flush=True)
        print(f"Best Val: {max(val_accs):.4f}", flush=True)
        print(f"Last Test: {test_accs[-1]:.4f}", flush=True)
        print(f"Best Test: {max(test_accs):.4f}", flush=True)
    return results
