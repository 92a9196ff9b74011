"""The single-card GIST round of ``gist_tpu_torch/train/ist_cluster.py:
train_ist_cluster`` (no mesh, no ``lsgd``), step for step, without its
eval and checkpoints.

The full-width model lives on the card.  A round (trainer: the body of
``for rnd in range(start_round, n_rounds)``):

1. the round's batches from the worker thread (``pending.result()``),
   and the next round's ``_RoundCollector.collect`` submitted to it;
2. ``_batches_to_device``, then ``sample_boundaries`` (on the host, the
   partitions moved to the card) and ``draw_seed``;
3. per subnet s: ``dispatch``, then the burst of
   ``build_local_burst_single``;
4. ``stack`` and ``merge``, and the losses to the host.

The set-up is the trainer's: ``ClusterSampler``, the sub-config and
boundary sizes of the model's kind, the burst function, the collector,
``sampler.tables`` on the card, the generators and the first
collection submitted to the worker.  What the trainer draws from its
seeds is drawn from the run's seed, but the cluster order, which is the
cell's data (:mod:`perfbench.reference.streams`); the initial
parameters are the benchmark's.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from gist_tpu_torch.ist.partition import sample_boundaries
from gist_tpu_torch.ist.slicing import dispatch, merge, stack
from gist_tpu_torch.ist.ultrawide import (build_local_burst_single,
                                          subnet_generator)
from gist_tpu_torch.models import gat
from gist_tpu_torch.sampler import ClusterSampler
from gist_tpu_torch.train.ist_cluster import (_batches_to_device,
                                              _RoundCollector)
from gist_tpu_torch.utils import draw_seed
from perfbench.reference.streams import (BOUNDARIES, CLUSTER_ORDER_SEED,
                                         DROPOUT, stream)

MODEL = "gat"


class Driver:
    def __init__(self, run):
        cfg, ds, dev = run.config, run.dataset, run.device
        self.run, self.dev, self.k = run, dev, run.num_subnet
        self.lr = cfg["lr"]
        model_cfg = gat.GATConfig(ds.in_feats, cfg["n_hidden"], ds.n_classes,
                                  n_layers=cfg["n_layers"],
                                  n_heads=cfg["n_heads"], dtype=run.dtype)
        self.sampler = ClusterSampler(ds, cfg["psize"], cfg["batch_size"],
                                      cache_dir=run.cache_dir,
                                      seed=CLUSTER_ORDER_SEED)
        self.full = {"layers": [{k: v.clone() for k, v in layer.items()}
                                for layer in run.init["layers"]]}
        sub_cfg = model_cfg.sub_config(num_subnet=self.k)
        self.sizes = [None] + [cfg["n_hidden"]] * (cfg["n_layers"] - 1) \
            + [None]
        self.burst = build_local_burst_single(
            gat, sub_cfg, weight_decay=cfg["weight_decay"])
        self.collector = _RoundCollector(self.sampler, cfg["iter_per_site"],
                                         ids_only=True)
        self.tables = self.sampler.tables(dev)
        self.part_gen = torch.Generator().manual_seed(
            stream(run.seed, BOUNDARIES))
        self.drop_gen = torch.Generator(device=dev).manual_seed(
            stream(run.seed, DROPOUT))
        self.pool = ThreadPoolExecutor(max_workers=1)
        self.pending = self.pool.submit(self._collect)
        self.capture = None

    def _collect(self):
        """The worker's collection, timed as a ``batch_build`` span of the
        worker thread."""
        t0 = time.time_ns()
        batches = self.collector.collect()
        self.run.spans.add("batch_build", t0, time.time_ns(),
                           threading.current_thread()
                           is threading.main_thread())
        return batches

    def run_round(self) -> tuple:
        """One round; returns (the batches it trained, its losses)."""
        sp, k, dev = self.run.spans, self.k, self.dev
        with sp("batch_wait"):
            batches = self.pending.result()
        self.pending = self.pool.submit(self._collect)
        self.run.record_batches(batches)
        with sp("batch_build"):
            dev_batches = _batches_to_device(batches, dev)
        with sp("dispatch"):
            bnds = [None if b is None else b.to(dev)
                    for b in sample_boundaries(self.part_gen, self.sizes, k)]
            seed = draw_seed(self.drop_gen)
        trained, round_losses = [], []
        for s in range(k):
            with sp("dispatch"):
                sub = dispatch(self.full, bnds, s, MODEL)
            with sp("burst"):
                sub, r = self.burst(sub, dev_batches, self.lr,
                                    subnet_generator(seed, s, dev),
                                    self.tables)
            trained.append(sub)
            round_losses.append(r)
        with sp("merge"):
            stacked = stack(trained)
            before = self.full
            self.full = merge(self.full, bnds, stacked, k, MODEL)
            losses = torch.stack(round_losses).cpu().numpy()
        if self.capture is not None:
            cpu = _to_cpu
            self.capture.update(
                bnds=[None if b is None else b.cpu() for b in bnds],
                before=cpu(before), trained=cpu(stacked),
                merged=cpu(self.full), merge_on=dev)
            self.capture = None
        return dev_batches, losses

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)
        self.pending = self.full = self.tables = None


def _to_cpu(params: dict) -> dict:
    return {"layers": [{k: v.cpu() for k, v in layer.items()}
                       for layer in params["layers"]]}
