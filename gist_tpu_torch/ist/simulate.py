"""Single-device IST, the GIST simulation (``gist_tpu/ist/simulate.py``,
the reference's ``gcn/train_ist.py``): K sub-models of the full-width
model train side by side on the full graph.

Cadence: every ``iter_per_site`` epochs a new partition of each split
boundary, a dispatch and a fresh Adam at the 50%/75% decayed learning
rate; a merge back into the full model every ``iter_per_site`` epochs
and at the end.

The JAX package ``vmap``s the K subnets and steps them with one Adam
on the summed loss.  Here the K sub-models are a loop: their losses are
summed into one backward and one Adam steps all their leaves.  The
subnets share no parameter and Adam is elementwise, so this is the same
step.

The graph is built by ``graph_from_edges`` without a layout, as in the
JAX package, so every aggregation takes the segment path and no kernel
is launched.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from gist_tpu_torch.convert import params_from_jax
from gist_tpu_torch.data.container import Dataset
from gist_tpu_torch.graph import graph_from_edges
from gist_tpu_torch.ist.partition import boundary_sizes, sample_boundaries
from gist_tpu_torch.ist.slicing import _take, dispatch, merge, stack
from gist_tpu_torch.models import gcn
from gist_tpu_torch.models.common import (masked_accuracy,
                                          masked_cross_entropy)
from gist_tpu_torch.train.common import (TrainConfig, make_optimizer,
                                         reference_lr_schedule)
from gist_tpu_torch.utils import resolve_device


def train_ist_simulation(
    ds: Dataset,
    model_cfg,
    tc: TrainConfig,
    *,
    model=gcn,
    kind: str = "gcn",
    fused: bool = False,
    init_params: Optional[dict] = None,
    device="cuda",
    verbose: bool = True,
) -> dict:
    """Train ``model`` (``gcn`` with kind "gcn", ``sage`` with kind
    "sage") with single-device IST on ``device``.

    Loop mode (default) evaluates the full model every epoch, between
    merges a stale read of it, and reports per-epoch losses and
    accuracies.  ``fused=True`` computes the same rounds, ``[ips] * n``
    epochs and the remainder, and reports one loss (the mean of the
    round's steps) and one eval a round, as the JAX package's jitted
    round does.  ``init_params`` (a numpy parameter tree, e.g. the JAX
    package's ``init`` output) replaces the seeded initialisation."""
    dev = resolve_device(device)
    run = _Simulation(ds, model_cfg, tc, model=model, kind=kind,
                      init_params=init_params, device=dev)
    results = run.fused() if fused else run.loop()
    if verbose:
        print(f"Final Test Accuracy: {results['final_test_acc']:.4f}")
        print(f"Best Val Accuracy: {results['best_val_acc']:.4f}")
        print(f"Best Test Accuracy: {results['best_test_acc']:.4f}")
        print(f"ETputs(KTEPS) {results['kteps']:.2f}")
    return results


class _Simulation:
    """The state both modes share: the graph and node data on the
    device, the full-width parameters, the boundary sizes and the
    partition and dropout generators."""

    def __init__(self, ds, model_cfg, tc, *, model, kind, init_params,
                 device):
        self.ds, self.cfg, self.tc = ds, model_cfg, tc
        self.model, self.kind, self.dev = model, kind, device
        self.K = tc.num_subnet
        self.graph = graph_from_edges(ds.senders, ds.receivers,
                                      ds.n_nodes).to(device)
        self.x = torch.from_numpy(ds.features).to(device)
        self.labels = torch.from_numpy(ds.labels).to(device)
        self.train_mask = torch.from_numpy(ds.train_mask).to(device)
        self.val_mask = torch.from_numpy(ds.val_mask).to(device)
        self.test_mask = torch.from_numpy(ds.test_mask).to(device)
        if init_params is None:
            self.params = model.init(
                torch.Generator(device=device).manual_seed(tc.seed),
                model_cfg)
        else:
            self.params = params_from_jax(init_params, device)
        self.sub_cfg = model_cfg.sub_config(
            split_input=tc.split_input, split_output=tc.split_output,
            num_subnet=self.K)
        self.sizes = boundary_sizes(
            model_cfg.in_feats, model_cfg.n_hidden, model_cfg.n_layers,
            split_input=tc.split_input, split_output=tc.split_output)
        self.part_gen = torch.Generator().manual_seed(tc.seed + 1)
        self.drop_gen = torch.Generator(device=device).manual_seed(
            tc.dropout_seed)

    def start_round(self, epoch):
        """A new partition, the K dispatched sub-models and a fresh Adam
        over all their leaves at the epoch's decayed learning rate."""
        bnds = [None if b is None else b.to(self.dev)
                for b in sample_boundaries(self.part_gen, self.sizes,
                                           self.K)]
        subs = [dispatch(self.params, bnds, s, self.kind)
                for s in range(self.K)]
        leaves = [t.requires_grad_(True) for sub in subs
                  for layer in sub["layers"] for t in layer.values()]
        lr = reference_lr_schedule(self.tc.lr, self.tc.n_epochs, epoch)
        xins = [self.x if bnds[0] is None else _take(self.x, bnds[0][s], 1)
                for s in range(self.K)]
        return bnds, subs, xins, make_optimizer(leaves, lr,
                                                self.tc.weight_decay)

    def step(self, subs, xins, opt) -> torch.Tensor:
        """One step of every subnet on the full graph; returns their K
        losses (on the device)."""
        opt.zero_grad(set_to_none=True)
        losses = torch.stack([
            masked_cross_entropy(
                self.model.apply(sub, self.graph, xin, self.sub_cfg,
                                 train=True, generator=self.drop_gen),
                self.labels, self.train_mask)
            for sub, xin in zip(subs, xins)])
        losses.sum().backward()
        opt.step()
        return losses.detach()

    def merge(self, bnds, subs):
        with torch.no_grad():
            self.params = merge(self.params, bnds,
                                stack([{"layers": [
                                    {k: v.detach() for k, v in l.items()}
                                    for l in sub["layers"]]}
                                    for sub in subs]),
                                self.K, self.kind)

    def evaluate(self):
        with torch.no_grad():
            logits = self.model.apply(self.params, self.graph, self.x,
                                      self.cfg)
            return (float(masked_accuracy(logits, self.labels,
                                          self.val_mask)),
                    float(masked_accuracy(logits, self.labels,
                                          self.test_mask)))

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def results(self, durs, val_accs, test_accs, losses, train_time):
        mean_dur = float(np.mean(durs)) if durs else 0.0
        return {
            "dataset": self.ds.name, "num_subnet": self.K,
            "final_test_acc": test_accs[-1],
            "best_val_acc": max(val_accs),
            "best_test_acc": max(test_accs),
            "val_accs": val_accs, "test_accs": test_accs,
            "losses": losses, "mean_epoch_s": mean_dur,
            "kteps": (self.graph.n_edges / mean_dur / 1000
                      if mean_dur else 0.0),
            "train_time": train_time(mean_dur),
        }

    def loop(self) -> dict:
        tc = self.tc
        ips = tc.iter_per_site
        durs, val_accs, test_accs, losses_hist = [], [], [], []
        for epoch in range(tc.n_epochs):
            t0 = time.time()
            if epoch % ips == 0:
                bnds, subs, xins, opt = self.start_round(epoch)
            losses = self.step(subs, xins, opt)
            if (epoch + 1) % ips == 0 or epoch == tc.n_epochs - 1:
                self.merge(bnds, subs)
            self.sync()
            if epoch >= 3:   # warm-up epochs excluded
                durs.append(time.time() - t0)
            va, ta = self.evaluate()
            val_accs.append(va)
            test_accs.append(ta)
            losses_hist.append(float(losses.mean()))
        return self.results(durs, val_accs, test_accs, losses_hist,
                            lambda d: d * max(len(durs), 1))

    def fused(self) -> dict:
        tc = self.tc
        ips = tc.iter_per_site
        n_rounds = max(tc.n_epochs // ips, 1)
        tail = tc.n_epochs - n_rounds * ips
        rounds = [ips] * n_rounds + ([tail] if tail > 0 else [])
        durs, val_accs, test_accs, losses_hist = [], [], [], []
        for rnd, n_steps in enumerate(rounds):
            t0 = time.time()
            bnds, subs, xins, opt = self.start_round(rnd * ips)
            step_means = torch.stack([self.step(subs, xins, opt).mean()
                                      for _ in range(n_steps)])
            self.merge(bnds, subs)
            va, ta = self.evaluate()
            self.sync()
            if rnd > 0:   # the first round is the warm-up
                durs.append((time.time() - t0) / n_steps)
            val_accs.append(va)
            test_accs.append(ta)
            losses_hist.append(float(step_means.mean()))
        results = self.results(durs, val_accs, test_accs, losses_hist,
                               lambda d: d * tc.n_epochs)
        results["fused"] = True
        return results
