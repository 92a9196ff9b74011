"""Ultra-wide IST: host-RAM-resident full-width parameters, device-
resident 1/K-width sub-models (``gist_tpu/ist/ultrawide.py``).

The host side (boundary sampling, dispatch, merge) is numpy and gives
the JAX package's results exactly.  The device side trains a 1/K-width
sub-model for a round's batches with a fresh Adam: one after another on
one device (:func:`build_local_burst_single`), or each rank of a
``subnet`` mesh its own, the trained shards then gathered over the mesh
(:func:`build_local_burst`, :func:`shard_over_subnets`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gist_tpu_torch.ist.partition import VIRTUAL_IDX
from gist_tpu_torch.ist.slicing import _take
from gist_tpu_torch.models.common import masked_cross_entropy
from gist_tpu_torch.sampler import ClusterSampler
from gist_tpu_torch.train.common import make_optimizer
from gist_tpu_torch.utils import fold_in

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


def dispatch_host(params: dict, bnds: Boundaries, num_subnet: int,
                  kind: str = "sage") -> dict:
    """Numpy slice of every subnet's shard, stacked on axis 0.  A SAGE
    weight's rows are the doubled input ``[h || Ah]``, so a split input
    boundary selects both halves; a GAT weight (H, in, out) splits axes 1
    and 2 and its ``attn`` (H, 2*out) the doubled output boundary."""
    layers_out = []
    for i, layer in enumerate(params["layers"]):
        b_in = bnds[i]
        b_out = bnds[i + 1] if i + 1 < len(bnds) else None
        ws, bs, attns = [], [], []
        for s in range(num_subnet):
            if kind in ("gcn", "sage"):
                w = layer["w"]
                if b_in is not None:
                    rows = (_full_idx_np(b_in[s], w.shape[0] // 2)
                            if kind == "sage" else b_in[s])
                    w = _gather_np(w, rows, axis=0)
                if b_out is not None:
                    w = _gather_np(w, b_out[s], axis=1)
                ws.append(w)
                b = layer["b"]
                bs.append(_gather_np(b, b_out[s], axis=0)
                          if b_out is not None else b)
            elif kind == "gat":
                w, attn = layer["w"], layer["attn"]
                if b_in is not None:
                    w = _gather_np(w, b_in[s], axis=1)
                if b_out is not None:
                    w = _gather_np(w, b_out[s], axis=2)
                    attn = _gather_np(
                        attn, _full_idx_np(b_out[s], attn.shape[1] // 2),
                        axis=1)
                ws.append(w)
                attns.append(attn)
            else:
                raise ValueError(kind)
        if kind == "gat":
            layers_out.append({"w": np.stack(ws), "attn": np.stack(attns)})
        else:
            layers_out.append({"w": np.stack(ws), "b": np.stack(bs)})
    return {"layers": layers_out}


def merge_host(params: dict, bnds: Boundaries, stacked: dict,
               num_subnet: int, kind: str = "sage") -> dict:
    """In-place numpy scatter of the trained shards into the full-width
    parameters; unsplit leaves take the mean over subnets."""
    for i, layer in enumerate(params["layers"]):
        b_in = bnds[i]
        b_out = bnds[i + 1] if i + 1 < len(bnds) else None
        sub = stacked["layers"][i]
        if kind in ("gcn", "sage"):
            w, b = layer["w"], layer["b"]
            if b_in is None and b_out is None:
                w[...] = sub["w"].mean(axis=0)
            else:
                for s in range(num_subnet):
                    rows = None if b_in is None else (
                        _full_idx_np(b_in[s], w.shape[0] // 2)
                        if kind == "sage" else b_in[s])
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
        elif kind == "gat":
            w, attn = layer["w"], layer["attn"]
            if b_in is None and b_out is None:
                w[...] = sub["w"].mean(axis=0)
            else:
                for s in range(num_subnet):
                    vr = None if b_in is None else b_in[s] < w.shape[1]
                    vc = None if b_out is None else b_out[s] < w.shape[2]
                    if b_in is not None and b_out is not None:
                        w[:, b_in[s][vr][:, None], b_out[s][vc][None, :]] = \
                            sub["w"][s][:, vr][:, :, vc]
                    elif b_in is not None:
                        w[:, b_in[s][vr], :] = sub["w"][s][:, vr]
                    else:
                        w[:, :, b_out[s][vc]] = sub["w"][s][:, :, vc]
            if b_out is None:
                attn[...] = sub["attn"].mean(axis=0)
            else:
                half = attn.shape[1] // 2
                for s in range(num_subnet):
                    fi = _full_idx_np(b_out[s], half)
                    vi = fi < attn.shape[1]
                    attn[:, fi[vi]] = sub["attn"][s][:, vi]
        else:
            raise ValueError(kind)
    return params


def subnet_generator(seed: int, s: int, device) -> torch.Generator:
    """Subnet ``s``'s dropout stream of a round whose seed is ``seed``."""
    return torch.Generator(device=device).manual_seed(fold_in(seed, s))


def _resolve(batch, tables):
    """(graph, feats, labels, mask) of an inline 4-tuple (``tables``
    None) or of a ClusterBatch."""
    if tables is None and isinstance(batch, tuple):
        return batch
    return ClusterSampler.resolve_batch(batch, tables)


def local_train(model, sub_cfg, sub: dict, batches, lr: float,
                weight_decay: float, generator: Optional[torch.Generator],
                tables, feat_idx: Optional[torch.Tensor] = None):
    """One subnet's burst, on one device or one rank of a mesh: a fresh
    Adam at ``lr``, one step per batch, trained in place; ``feat_idx``
    selects the subnet's input columns (``split_input``).  Returns
    (sub, losses) with the losses on the device."""
    leaves = [t for layer in sub["layers"] for t in layer.values()]
    for t in leaves:
        t.requires_grad_(True)
    opt = make_optimizer(leaves, lr, weight_decay)
    losses = []
    for batch in batches:
        graph, feats, labels, mask = _resolve(batch, tables)
        if feat_idx is not None:
            feats = _take(feats, feat_idx, 1)
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


def build_local_burst_single(model, sub_cfg, *, weight_decay: float):
    """Sequential-subnet burst (``gist_tpu/ist/ultrawide.py:230``):
    ``burst(sub, batches, lr, generator, tables) -> (sub, losses)``.

    ``sub`` is one sub-model's parameter tree of tensors on the device;
    it is trained in place for one step per batch with a fresh Adam at
    ``lr``.  ``batches`` are ids-form ClusterBatches on that device,
    ``tables`` the sampler's tables there; dropout draws from
    ``generator``.  Losses stay on the device (no synchronisation)."""

    def burst(sub, batches, lr, generator, tables):
        return local_train(model, sub_cfg, sub, batches, lr, weight_decay,
                           generator, tables)

    return burst


def build_local_burst(model, sub_cfg, *, mesh, weight_decay: float):
    """The ``subnet`` mesh's burst (``gist_tpu/ist/ultrawide.py:186``):
    ``burst(sub, batches, lr, seed, tables) -> (stacked, losses)``.

    ``sub`` is this rank's shard (:func:`shard_over_subnets`), trained
    in place as the sequential burst trains one, with dropout from the
    subnet's stream of the round's ``seed``
    (:func:`subnet_generator`); then every
    rank's trained shard is gathered: ``stacked`` holds them on a
    leading (K,) axis on this rank's device, ``losses`` is (K, steps)."""
    from gist_tpu_torch.parallel import comm
    s = mesh.get_local_rank("subnet")
    group = mesh.get_group("subnet")
    device = comm.mesh_device(mesh)

    def burst(sub, batches, lr, seed, tables):
        sub, losses = local_train(model, sub_cfg, sub, batches, lr,
                                  weight_decay,
                                  subnet_generator(seed, s, device), tables)
        return (comm.all_gather_tree(sub, group),
                comm.all_gather_stack(losses, group))

    return burst


def shard_over_subnets(mesh, stacked_np: dict) -> dict:
    """This rank's shard of the host-stacked shards (leading (K,) axis),
    as tensors on its device."""
    from gist_tpu_torch.parallel import comm
    s = mesh.get_local_rank("subnet")
    device = comm.mesh_device(mesh)
    return {"layers": [
        {k: torch.tensor(v[s], device=device) for k, v in layer.items()}
        for layer in stacked_np["layers"]]}
