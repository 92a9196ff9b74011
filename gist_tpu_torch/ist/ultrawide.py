"""Ultra-wide IST: host-RAM-resident full-width parameters, device-
resident 1/K-width sub-models (``gist_tpu/ist/ultrawide.py``).

The host side (boundary sampling, dispatch, merge) is numpy and gives
the JAX package's results exactly.  The device side is the sequential
burst: one sub-model at a time trains for a round's batches with a
fresh Adam.  The mesh burst (``build_local_burst``) waits for the
distributed slice.
"""

from __future__ import annotations

import numpy as np
import torch

from gist_tpu_torch.ist.partition import VIRTUAL_IDX
from gist_tpu_torch.models.common import masked_cross_entropy
from gist_tpu_torch.sampler import ClusterSampler
from gist_tpu_torch.train.common import make_optimizer

Boundaries = list  # per boundary: np.ndarray (K, chunk) or None


def sample_boundaries_host(rng: np.random.Generator, sizes, num_subnet):
    """A random disjoint split of each boundary into ``num_subnet`` equal
    chunks; non-divisible sizes pad with VIRTUAL_IDX entries (zero rows
    at dispatch, dropped at merge)."""
    out = []
    for size in sizes:
        if size is None:
            out.append(None)
        else:
            c = -(-size // num_subnet)
            perm = rng.permutation(num_subnet * c).astype(np.int64)
            if num_subnet * c != size:
                perm = np.where(perm < size, perm, VIRTUAL_IDX)
            out.append(perm.reshape(num_subnet, c))
    return out


def _full_idx_np(idx, half):
    return np.concatenate([idx, idx + half])


def _gather_np(a, idx, axis):
    """np.take with VIRTUAL_IDX entries reading zero."""
    n = a.shape[axis]
    valid = idx < n
    out = np.take(a, np.minimum(idx, n - 1), axis=axis)
    if not valid.all():
        sl = [slice(None)] * a.ndim
        sl[axis] = ~valid
        out[tuple(sl)] = 0
    return out


def dispatch_host(params: dict, bnds: Boundaries, num_subnet: int) -> dict:
    """Numpy slice of every subnet's SAGE shard, stacked on axis 0.  A
    SAGE weight's rows are the doubled input ``[h || Ah]``, so a split
    input boundary selects both halves."""
    layers_out = []
    for i, layer in enumerate(params["layers"]):
        b_in = bnds[i]
        b_out = bnds[i + 1] if i + 1 < len(bnds) else None
        ws, bs = [], []
        for s in range(num_subnet):
            w = layer["w"]
            if b_in is not None:
                w = _gather_np(w, _full_idx_np(b_in[s], w.shape[0] // 2),
                               axis=0)
            if b_out is not None:
                w = _gather_np(w, b_out[s], axis=1)
            ws.append(w)
            b = layer["b"]
            bs.append(_gather_np(b, b_out[s], axis=0)
                      if b_out is not None else b)
        layers_out.append({"w": np.stack(ws), "b": np.stack(bs)})
    return {"layers": layers_out}


def merge_host(params: dict, bnds: Boundaries, stacked: dict,
               num_subnet: int) -> dict:
    """In-place numpy scatter of the trained shards into the full-width
    SAGE parameters; unsplit leaves take the mean over subnets."""
    for i, layer in enumerate(params["layers"]):
        b_in = bnds[i]
        b_out = bnds[i + 1] if i + 1 < len(bnds) else None
        sub = stacked["layers"][i]
        w, b = layer["w"], layer["b"]
        if b_in is None and b_out is None:
            w[...] = sub["w"].mean(axis=0)
        else:
            for s in range(num_subnet):
                rows = None if b_in is None else _full_idx_np(
                    b_in[s], w.shape[0] // 2)
                # vr/vc drop VIRTUAL_IDX padding (non-divisible dims)
                vr = None if rows is None else rows < w.shape[0]
                vc = None if b_out is None else b_out[s] < w.shape[1]
                if rows is not None and b_out is not None:
                    w[np.ix_(rows[vr], b_out[s][vc])] = \
                        sub["w"][s][np.ix_(vr, vc)]
                elif rows is not None:
                    w[rows[vr], :] = sub["w"][s][vr]
                else:
                    w[:, b_out[s][vc]] = sub["w"][s][:, vc]
        if b_out is None:
            b[...] = sub["b"].mean(axis=0)
        else:
            for s in range(num_subnet):
                vc = b_out[s] < b.shape[0]
                b[b_out[s][vc]] = sub["b"][s][vc]
    return params


def build_local_burst_single(model, sub_cfg, *, weight_decay: float):
    """Sequential-subnet burst (``gist_tpu/ist/ultrawide.py:230``):
    ``burst(sub, batches, lr, generator, tables) -> (sub, losses)``.

    ``sub`` is one sub-model's parameter tree of tensors on the device;
    it is trained in place for one step per batch with a fresh Adam at
    ``lr``.  ``batches`` are ids-form ClusterBatches on that device,
    ``tables`` the sampler's tables there; dropout draws from
    ``generator``.  Losses stay on the device (no synchronisation)."""

    def burst(sub, batches, lr, generator, tables):
        leaves = [t for layer in sub["layers"] for t in layer.values()]
        for t in leaves:
            t.requires_grad_(True)
        opt = make_optimizer(leaves, lr, weight_decay)
        losses = []
        for batch in batches:
            graph, feats, labels, mask = ClusterSampler.resolve_batch(
                batch, tables)
            opt.zero_grad(set_to_none=True)
            logits = model.apply(sub, graph, feats, sub_cfg, train=True,
                                 generator=generator)
            loss = masked_cross_entropy(logits, labels, mask)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        for t in leaves:
            t.requires_grad_(False)
        return sub, torch.stack(losses)

    return burst
