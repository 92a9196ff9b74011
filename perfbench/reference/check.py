"""The comparison that decides ``correct``: the round that the program
runs after the window, its first round and a sample of the window's
batches, against the plain reference, worked out from the raw graph, the
cached partition, the run's seed, the benchmark's initial parameters
and, for the compared round, the parameters the program's rounds left
(the reference follows a round from that state, and checks the first
round's start and the merges by themselves).

Numbers (each held to a limit of its cell's, ``perfbench/limits``):

* ``partition_faults``: train nodes the cached clusters miss or hold
  twice;
* ``batch_faults``: sampled batches (the first three of the first round
  and ``check_batches`` of every later collection) whose node ids,
  padded size or induced edges differ from the reference's;
* ``boundary_faults``: entries of the compared round's IST boundaries
  that differ from the reference's draw for that round;
* ``dispatch_faults``: elements of a sub-model's parameters, as its
  optimizer first got them, that differ from the reference's slice of
  the parameters the compared round started from;
* ``loss_gap``: the largest relative gap between the program's and the
  reference's loss over the first three steps of every subnet's burst
  in the compared round (the losses the burst returns);
* ``grad_gap``: the largest gap, over leaves and subnets, between the
  norm of the program's first gradient (as its Adam got it, decay
  added) and the reference's, over the larger of the reference leaf's
  norm and the median leaf's;
* ``update_gap``: the median leaf's gap (the largest over subnets), with
  the same measure, of the change of the leaves over the three steps,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (round-off alone moves them under Adam).  The median
  leaf and not the worst: a ReLU that flips on rounding moves the
  gradient of the layers below it by ~1e-5 on some seeds and not on
  others, and Adam's later steps carry that into a few leaves' change,
  so the worst leaf swings from 1e-8 to 6e-5 between seeds (PERF.md).
  An optimizer that the hooks never saw reads as every element
  dispatched wrong, a first gradient of nought and no change;
* ``merge_faults``: elements of the merged full-width parameters that
  differ from the reference's merge of the program's trained shards
  into the parameters the round started from, in the first round (which
  starts from the benchmark's parameters: elements that differ count
  too) and in the compared round.  The reference follows a burst no
  further than three steps, so the merge is checked from the program's
  own shards;
* ``stale_leaves``: leaves that the rounds between the first round's
  merge and the compared round's start left unchanged in every element
  (with a round between them; 0 where there is none).

Plain PyTorch and numpy; nothing of the program is imported.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import models
from perfbench.reference.batches import (BatchStream, TrainGraph,
                                         bucket_size, check_partition,
                                         same_edges)
from perfbench.reference.streams import (BOUNDARIES, CLUSTER_ORDER_SEED,
                                         fold_in, round_seeds, stream)

SKIP_BELOW = 1e-3   # a leaf's gradient norm under this x the median's


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)) if isinstance(a, np.ndarray) \
        else torch.as_tensor(a)


def _faults(a: dict, b: dict) -> int:
    """Elements that differ between two parameter trees."""
    return sum(int((_t(x).cpu() != _t(y).cpu()).sum())
               for la, lb in zip(a["layers"], b["layers"])
               for x, y in ((la[k], lb[k]) for k in la))


def _leaf_gaps(prog: list, ref: list, keep: list) -> list:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's (None for a leaf left out)."""
    rn = [float(r.double().norm()) for r in ref]
    pn = [float(p.double().norm()) for p in prog]
    med = statistics.median(rn)
    return [abs(p - r) / max(r, med) if k else None
            for p, r, k in zip(pn, rn, keep)]


def _worst(gaps: list) -> float:
    return max((g for g in gaps if g is not None), default=0.0)


def _median(gaps: list) -> float:
    return statistics.median(g for g in gaps if g is not None)


def _leaves(params: dict) -> list:
    return [t for layer in params["layers"] for t in layer.values()]


def _tree(template: dict, leaves: list) -> list:
    it = iter(leaves)
    return [{k: next(it) for k in layer} for layer in template["layers"]]


def _draw_bounds(model: str, seed: int, sizes: list, k: int,
                 rounds: int) -> list:
    """The boundaries of round ``rounds - 1``: the trainer's draws, one a
    round, from the run's stream ``BOUNDARIES``."""
    if model == "sage":
        rng = np.random.default_rng(stream(seed, BOUNDARIES))
        draws = [models.boundaries_host(rng, sizes, k)
                 for _ in range(rounds)]
    else:
        gen = torch.Generator().manual_seed(stream(seed, BOUNDARIES))
        draws = [models.boundaries_torch(gen, sizes, k)
                 for _ in range(rounds)]
    return draws[-1]


def _merge_faults(model: str, on, bnds: list, before: dict,
                  trained: dict, merged: dict) -> int:
    """Elements of ``merged`` that differ from the reference's merge of
    ``trained`` into ``before``, worked out where the program merged."""
    before, trained = ({"layers": [{key: _t(v).to(on) for key, v in
                                    layer.items()} for layer in t["layers"]]}
                       for t in (before, trained))
    ref = models.merge(model, before, [None if b is None else _t(b)
                                       for b in bnds], trained)
    return _faults(ref, merged)


def _stale_leaves(start: dict, first_merge: dict) -> int:
    """Leaves that the rounds between the first merge and ``start`` left
    unchanged in every element."""
    return sum(int(bool((_t(a).cpu() == _t(b).cpu()).all()))
               for la, lb in zip(start["layers"], first_merge["layers"])
               for a, b in ((la[k], lb[k]) for k in la))


def run_checks(model: str, cfg: dict, traffic: dict, ds, arrays: dict,
               parts: list, seed: int, init: dict, first: dict,
               compared: dict, sampled: list, device) -> dict:
    """The cell's numbers (see the module docstring), and each compared
    leaf's gradient and update gaps by subnet.  ``first`` is the first
    round's capture (its boundaries, start, trained shards and merge),
    ``compared`` the compared round's (the same, its index, the
    optimizers' leaves and first gradients, and the burst's losses)."""
    out = {}
    k, ipr = traffic["num_subnet"], cfg["iter_per_site"]
    r = compared["index"]
    tg = TrainGraph(arrays, device)
    out["partition_faults"] = check_partition(parts, tg.n_train)
    stream_ = BatchStream(parts, cfg["batch_size"], CLUSTER_ORDER_SEED)

    def pad_of(j: int) -> int:
        c = j // ipr
        return max(bucket_size(len(stream_.node_ids(i)))
                   for i in range(c * ipr, (c + 1) * ipr))

    bad = 0
    for b in sampled:
        ids = stream_.node_ids(b["j"])
        src, dst = tg.induced(ids)
        bad += not (np.array_equal(ids, b["ids"]) and b["n_pad"] == pad_of(
            b["j"]) and same_edges(b["src"], b["dst"], src, dst, len(ids)))
    out["batch_faults"] = bad

    # the compared round's first steps, from the state it started from
    n_pad = pad_of(r * ipr)
    feats = torch.from_numpy(arrays["features"])
    labels = torch.from_numpy(arrays["labels"]).long()
    batches = []
    for j in range(r * ipr, r * ipr + 3):
        ids = stream_.node_ids(j)
        gid = torch.from_numpy(tg.train_nid[ids])
        x = torch.zeros((n_pad, feats.shape[1]))
        x[:len(ids)] = feats[gid]
        src, dst = tg.induced(ids)
        batches.append((x.to(device), src, dst, labels[gid].to(device)))
    del tg

    sizes = models.boundary_sizes(model, ds.in_feats, cfg["n_hidden"],
                                  cfg["n_layers"])
    bnds = _draw_bounds(model, seed, sizes, k, r + 1)
    out["boundary_faults"] = sum(
        int((_t(a) != _t(b)).sum()) if a is not None else int(b is not None)
        for a, b in zip(bnds, compared["bnds"]))

    full = {"layers": [{key: _t(v).to(device) for key, v in layer.items()}
                       for layer in compared["before"]["layers"]]}
    round_seed = round_seeds(seed, r + 1, device)[r]
    dispatch_bad, loss_gap, grad_gap, update_gap = 0, 0.0, 0.0, 0.0
    detail = {"grad": [], "update": []}
    for s in range(k):
        sub = models.dispatch(model, full, bnds, s)
        leaves = _leaves(sub)
        # an optimizer the hooks never saw counts as every element
        # wrong, a gradient of nought and an unchanged state
        seen = s < min(len(compared["p0"]), len(compared["g1"]),
                       len(compared["p3"]))
        p0 = compared["p0"][s] if seen else [t.cpu() for t in leaves]
        dispatch_bad += sum(int((p.to(device) != q).sum())
                            for p, q in zip(p0, leaves)) if seen \
            else sum(t.numel() for t in leaves)
        g1p = compared["g1"][s] if seen else [torch.zeros_like(t)
                                              for t in p0]
        p3p = compared["p3"][s] if seen else p0
        gen = torch.Generator(device=device).manual_seed(
            fold_in(round_seed, s))

        def loss_fn(p, batch, sub=sub, gen=gen):
            x, src, dst, y = batch
            layers = _tree(sub, p)
            if model == "sage":
                logits = models.sage_forward(layers, x, src, dst,
                                             cfg["dropout"], gen)
            else:
                logits = models.gat_forward(layers, x, src, dst)
            return F.cross_entropy(logits[:len(y)], y)

        losses, g1, p3 = models.adam_steps(leaves, loss_fn, batches,
                                           cfg["lr"], cfg["weight_decay"])
        prog_losses = np.asarray(compared["losses"][s][:3], np.float64)
        loss_gap = max(loss_gap, float(np.max(
            np.abs(prog_losses - losses) / np.abs(losses))))
        g1c = [g.cpu() for g in g1]
        gaps = _leaf_gaps(g1p, g1c, [True] * len(g1c))
        detail["grad"].append(gaps)
        grad_gap = max(grad_gap, _worst(gaps))
        med = statistics.median(float(g.double().norm()) for g in g1c)
        moved = [float(g.double().norm()) >= SKIP_BELOW * med for g in g1c]
        gaps = _leaf_gaps([a - b for a, b in zip(p3p, p0)],
                          [(a - b).cpu() for a, b in zip(p3, leaves)], moved)
        detail["update"].append(gaps)
        update_gap = max(update_gap, _median(gaps))
    out.update(dispatch_faults=dispatch_bad, loss_gap=loss_gap,
               grad_gap=grad_gap, update_gap=update_gap)

    # the merges, where the program merged (the host or the card): the
    # first round's from the benchmark's parameters, and the compared
    # round's; then the window's rounds, which moved every leaf
    first_bnds = _draw_bounds(model, seed, sizes, k, 1)
    out["merge_faults"] = (
        _faults(first["before"], init)
        + _merge_faults(model, first["merge_on"], first_bnds, init,
                        first["trained"], first["merged"])
        + _merge_faults(model, compared["merge_on"], bnds,
                        compared["before"], compared["trained"],
                        compared["merged"]))
    out["stale_leaves"] = _stale_leaves(compared["before"], first["merged"]) \
        if r >= 2 else 0
    return out, detail
