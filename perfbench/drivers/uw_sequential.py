"""The ultra-wide GIST round, sequential mode: the round of
``gist_tpu_torch/train/ist_ultrawide.py:train_ist_ultrawide`` with
``sequential=True``, step for step, without its eval and checkpoints.

The full-width parameters live in host RAM as numpy.  A round
(trainer: the body of ``for rnd in range(start_round, n_rounds)``):

1. ``sample_boundaries_host``, ``draw_seed`` and ``dispatch_host``;
2. per subnet s: the sub-parameters to the card (``torch.tensor``), then
   the burst of ``build_local_burst_single`` (``local_train``: a fresh
   Adam, one step per batch);
3. after subnet 0's burst is queued: the next round's batches
   (``_RoundCollector.collect`` and ``_batches_to_device``, the trainer's
   ``prep_next``);
4. per subnet ``params_to_numpy`` and the losses to the host, then
   ``merge_host``.

The set-up is the trainer's: ``ClusterSampler``, the boundary sizes,
the burst function, the collector, ``sampler.tables`` on the card and
the first round's batches.  What the trainer draws from its seeds is
drawn from the run's seed, but the cluster order, which is the cell's
data (:mod:`perfbench.reference.streams`); the initial parameters are
the benchmark's.
"""

from __future__ import annotations

import numpy as np
import torch

from gist_tpu_torch.convert import params_to_numpy
from gist_tpu_torch.ist.partition import boundary_sizes
from gist_tpu_torch.ist.ultrawide import (build_local_burst_single,
                                          dispatch_host, merge_host,
                                          sample_boundaries_host,
                                          subnet_generator)
from gist_tpu_torch.models import sage
from gist_tpu_torch.sampler import ClusterSampler
from gist_tpu_torch.train.ist_cluster import (_batches_to_device,
                                              _RoundCollector)
from gist_tpu_torch.utils import draw_seed
from perfbench.reference.streams import (BOUNDARIES, CLUSTER_ORDER_SEED,
                                         DROPOUT, stream)

MODEL = "sage"


class Driver:
    def __init__(self, run):
        cfg, ds, dev = run.config, run.dataset, run.device
        self.run, self.dev, self.k = run, dev, run.num_subnet
        self.lr = cfg["lr"]
        model_cfg = sage.SAGEConfig(ds.in_feats, cfg["n_hidden"],
                                    ds.n_classes, n_layers=cfg["n_layers"],
                                    dropout=cfg["dropout"], dtype=run.dtype)
        self.sampler = ClusterSampler(ds, cfg["psize"], cfg["batch_size"],
                                      cache_dir=run.cache_dir,
                                      seed=CLUSTER_ORDER_SEED)
        self.full = {"layers": [
            {k: v.detach().cpu().numpy().copy() for k, v in layer.items()}
            for layer in run.init["layers"]]}
        sub_cfg = model_cfg.sub_config(split_input=False, split_output=True,
                                       num_subnet=self.k)
        self.sizes = boundary_sizes(ds.in_feats, cfg["n_hidden"],
                                    cfg["n_layers"], split_input=False,
                                    split_output=True)
        self.burst = build_local_burst_single(
            sage, sub_cfg, weight_decay=cfg["weight_decay"])
        self.collector = _RoundCollector(self.sampler, cfg["iter_per_site"],
                                         ids_only=True)
        self.tables = self.sampler.tables(dev)
        self.host_rng = np.random.default_rng(stream(run.seed, BOUNDARIES))
        self.generator = torch.Generator(device=dev).manual_seed(
            stream(run.seed, DROPOUT))
        self.batches = self._collect()
        self.capture = None

    def _collect(self):
        batches = self.collector.collect()
        self.run.record_batches(batches)
        return _batches_to_device(batches, self.dev)

    def run_round(self) -> tuple:
        """One round; returns (the batches it trained, its losses)."""
        sp, k, dev = self.run.spans, self.k, self.dev
        batches = self.batches
        with sp("dispatch"):
            bnds = sample_boundaries_host(self.host_rng, self.sizes, k)
            seed = draw_seed(self.generator)
            shards_np = dispatch_host(self.full, bnds, k, MODEL)
        trained_list, loss_list = [], []
        for s in range(k):
            with sp("dispatch"):
                sub = {"layers": [
                    {key: torch.tensor(v[s], device=dev)
                     for key, v in layer.items()}
                    for layer in shards_np["layers"]]}
            with sp("burst"):
                sub, rl = self.burst(sub, batches, self.lr,
                                     subnet_generator(seed, s, dev),
                                     self.tables)
            if s == 0:
                with sp("batch_build"):
                    next_batches = self._collect()
            with sp("merge"):
                trained_list.append(params_to_numpy(sub))
                loss_list.append(rl.cpu().numpy())
        with sp("merge"):
            trained = {"layers": [
                {key: np.stack([t["layers"][i][key] for t in trained_list])
                 for key in layer}
                for i, layer in enumerate(self.full["layers"])]}
            if self.capture is not None:
                before = _copy(self.full)
            self.full = merge_host(self.full, bnds, trained, k, MODEL)
        if self.capture is not None:
            self.capture.update(bnds=bnds, before=before, trained=trained,
                                merged=_copy(self.full), merge_on="cpu")
            self.capture = None
        self.batches = next_batches
        return batches, np.asarray(loss_list)

    def close(self):
        self.batches = self.tables = None


def _copy(params: dict) -> dict:
    return {"layers": [{k: v.copy() for k, v in layer.items()}
                       for layer in params["layers"]]}
