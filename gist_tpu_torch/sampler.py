"""Cluster-GCN mini-batch sampler (``gist_tpu/sampler.py``).

Batches are the node-induced subgraphs of ``batch_size`` random
clusters, padded to geometric size buckets as in the JAX package, so
the two packages draw identical node-id streams and build identical
batches and layouts from one seed (the RNG is numpy).  Batches are
built on the host as CPU tensors; trainers move them to their device.

A multitask dataset (``labels_multi`` set) trains on its (N, C)
multi-hot matrix: batches and tables then carry float32 (N, C) labels.
With ``use_pp`` the features are ``[X || (A X) * 1/deg]`` over the train
subgraph (``_precalc``), and the model skips its first aggregation in
training.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, replace
from typing import Iterator, List, Optional

import numpy as np
import torch

from gist_tpu_torch.data.container import Dataset
from gist_tpu_torch.graph import Graph, graph_from_edges, subgraph
from gist_tpu_torch.partition import get_partition_list


# batches grow in geometric buckets (~log_1.2 distinct padded shapes);
# below TILES_MIN_EDGES edges a batch keeps the segment path, as in the
# JAX package, where the kernel would not pay for its layout build
BUCKET_GROWTH = 1.2
TILES_MIN_EDGES = 200_000


def bucket_size(n: int, growth: float = BUCKET_GROWTH,
                min_size: int = 256) -> int:
    """Smallest bucket >= n from the geometric series min_size*growth^k."""
    if n <= min_size:
        return min_size
    k = math.ceil(math.log(n / min_size) / math.log(growth))
    return int(math.ceil(min_size * growth ** k))


@dataclass(frozen=True)
class ClusterBatch:
    """A padded training batch: induced subgraph + node data, either
    inline (features/labels/train_mask per batch) or as ``node_ids`` into
    the sampler's ``tables()`` (padding ids point at the zero row)."""
    graph: Graph
    features: Optional[torch.Tensor]    # (N_pad, F) or None (ids form)
    labels: Optional[torch.Tensor]      # (N_pad,) or (N_pad, C), or None
    train_mask: Optional[torch.Tensor]  # (N_pad,) — False on padding
    n_real_nodes: int
    n_real_edges: int
    node_ids: Optional[torch.Tensor] = None  # (N_pad,) into tables()

    def replace(self, **kw) -> "ClusterBatch":
        return replace(self, **kw)

    def to(self, device) -> "ClusterBatch":
        def mv(t):
            return None if t is None else t.to(device)
        return replace(self, graph=self.graph.to(device),
                       features=mv(self.features), labels=mv(self.labels),
                       train_mask=mv(self.train_mask),
                       node_ids=mv(self.node_ids))


def unify_tile_buckets(batches: List[ClusterBatch]) -> List[ClusterBatch]:
    """Re-pad per-batch layouts to one common bucket
    (``gist_tpu/sampler.py:unify_tile_buckets``): the v1 pairs first,
    then the dedup pairs.  Batches whose layout build bailed force that
    layout off for the whole round, so every batch of a round takes the
    same aggregation path."""
    batches = _unify_gather_tiles(batches)
    graphs = [b.graph for b in batches]
    have = [g.dedup is not None and g.dedup_t is not None for g in graphs]
    if not all(have):
        if any(g.dedup is not None or g.dedup_t is not None
               for g in graphs):
            batches = [
                b.replace(graph=b.graph.replace(dedup=None, dedup_t=None))
                for b in batches]
        return batches
    from gist_tpu_torch.graph import pad_dedup_tiles

    def pads(ds):
        return (max(int(d.w_blocks.shape[0]) for d in ds),
                max(d.max_jobs for d in ds))

    jb, mj = pads([g.dedup for g in graphs])
    jbt, mjt = pads([g.dedup_t for g in graphs])
    out = []
    for b in batches:
        g = b.graph
        if (int(g.dedup.w_blocks.shape[0]) == jb and g.dedup.max_jobs == mj
                and int(g.dedup_t.w_blocks.shape[0]) == jbt
                and g.dedup_t.max_jobs == mjt):
            out.append(b)
            continue
        out.append(b.replace(graph=g.replace(
            dedup=pad_dedup_tiles(g.dedup, jb, mj),
            dedup_t=pad_dedup_tiles(g.dedup_t, jbt, mjt))))
    return out


def _tensor_fields(obj, prefix=""):
    """(name, value) of every field of a Graph and of its layouts, by
    dotted name; layouts that are None come as None."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _tensor_fields(v, f"{prefix}{f.name}.")
        else:
            yield prefix + f.name, v


def _with_tensors(obj, tensors: dict, i: int, prefix=""):
    """``obj`` with each tensor field replaced by row ``i`` of the
    stacked tensor of the same name."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        name = prefix + f.name
        if dataclasses.is_dataclass(v):
            kw[f.name] = _with_tensors(v, tensors, i, f"{name}.")
        elif isinstance(v, torch.Tensor):
            kw[f.name] = tensors[name][i]
    return dataclasses.replace(obj, **kw)


@dataclass(frozen=True)
class StackedEpoch:
    """A round of ids-form batches stacked on a leading axis (the JAX
    package's ``_stack_batches``): ``tensors`` maps each graph field
    (dotted, e.g. ``dedup.w_blocks``) and ``node_ids`` to its (B, ...)
    stack; ``template`` is batch 0's graph, whose host values (node
    count, ``max_jobs``, ``max_chunks``) every batch shares after
    :func:`unify_tile_buckets`; ``key`` names the shapes, the key of a
    capture."""
    tensors: dict
    template: Graph
    key: tuple

    def views(self, tensors: Optional[dict] = None) -> list:
        """(graph, node_ids) of each batch, as views of ``tensors``
        (default: the stack itself; a caller passes its static copy of
        it on the card)."""
        tensors = self.tensors if tensors is None else tensors
        n = tensors["node_ids"].shape[0]
        return [(_with_tensors(self.template, tensors, i),
                 tensors["node_ids"][i]) for i in range(n)]


def stack_batches(batches: List[ClusterBatch]) -> StackedEpoch:
    """Stack a round of ids-form batches (re-padded first by
    :func:`unify_tile_buckets`) on the host.  ``n_edges`` becomes the
    padded count, as in the JAX package, since it differs per batch."""
    batches = unify_tile_buckets(batches)
    graphs = [b.graph.replace(n_edges=b.graph.n_edges_padded)
              for b in batches]
    fields = [dict(_tensor_fields(g)) for g in graphs]
    names = [k for k, v in fields[0].items() if isinstance(v, torch.Tensor)]
    statics = tuple((k, v) for k, v in fields[0].items() if k not in names)
    for f in fields[1:]:
        if tuple((k, v) for k, v in f.items() if k not in names) != statics:
            raise ValueError("batches of one round differ in a host value "
                             "of their layouts; re-pad them to one bucket")
    tensors = {k: torch.stack([f[k] for f in fields]) for k in names}
    tensors["node_ids"] = torch.stack([b.node_ids for b in batches])
    key = statics + tuple((k, tuple(t.shape), t.dtype)
                          for k, t in tensors.items())
    return StackedEpoch(tensors=tensors, template=graphs[0], key=key)


def _unify_gather_tiles(batches: List[ClusterBatch]) -> List[ClusterBatch]:
    """The v1 counterpart of the dedup unification
    (``gist_tpu/sampler.py:108``): one slot count and ``max_chunks`` per
    direction for the round."""
    graphs = [b.graph for b in batches]
    have = [g.tiled is not None and g.tiled_t is not None for g in graphs]
    if not all(have):
        if any(g.tiled is not None or g.tiled_t is not None
               for g in graphs):
            batches = [
                b.replace(graph=b.graph.replace(tiled=None, tiled_t=None))
                for b in batches]
        return batches
    from gist_tpu_torch.graph import pad_tiled_csr

    def pads(ts):
        return (max(t.senders.shape[0] for t in ts),
                max(t.max_chunks for t in ts))

    eb, mc = pads([g.tiled for g in graphs])
    ebt, mct = pads([g.tiled_t for g in graphs])
    out = []
    for b in batches:
        g = b.graph
        if (g.tiled.senders.shape[0] == eb and g.tiled.max_chunks == mc
                and g.tiled_t.senders.shape[0] == ebt
                and g.tiled_t.max_chunks == mct):
            out.append(b)
            continue
        out.append(b.replace(graph=g.replace(
            tiled=pad_tiled_csr(g.tiled, eb, mc),
            tiled_t=pad_tiled_csr(g.tiled_t, ebt, mct))))
    return out


class ClusterSampler:
    """Iterates ``psize // batch_size`` padded cluster batches per epoch,
    reshuffling the cluster order between epochs."""

    def __init__(
        self,
        ds: Dataset,
        psize: int,
        batch_size: int,
        *,
        use_pp: bool = False,
        cache_dir: Optional[str] = None,
        seed: int = 0,
        tiles: Optional[bool] = None,
        tile_mode: str = "dedup",
    ):
        """``tiles=None`` (auto): build a layout on each batch when a
        kernel backend is active (``tiles_wanted``) and the batch has at
        least ``TILES_MIN_EDGES`` edges; layout shapes are padded to the
        same geometric buckets as nodes/edges.  ``tile_mode`` picks the
        layout: ``"dedup"`` the block-dense pair, ``"gather"`` the
        linked v1 pair (``TiledCSR``)."""
        if tile_mode not in ("dedup", "gather"):
            raise ValueError(f"tile_mode must be 'dedup' or 'gather', not "
                             f"{tile_mode!r}")
        self.psize = psize
        self.batch_size = batch_size
        self.use_pp = use_pp
        self.rng = np.random.default_rng(seed)
        self.tiles = tiles
        self.tile_mode = tile_mode

        # restrict to the train-node-induced subgraph
        train_nid = np.nonzero(ds.train_mask)[0]
        s, r, _ = subgraph(ds.senders, ds.receivers, train_nid, ds.n_nodes)
        self.senders, self.receivers = s, r
        self.n_nodes = len(train_nid)
        self.features = ds.features[train_nid]
        self.labels = ds.labels_multi[train_nid].astype(np.float32) \
            if ds.labels_multi is not None else ds.labels[train_nid]
        self.train_mask = ds.train_mask[train_nid]  # all True

        self.partitions: List[np.ndarray] = get_partition_list(
            self.senders, self.receivers, self.n_nodes, psize,
            cache_dir=cache_dir, name=ds.name, seed=seed)
        self._order = np.arange(len(self.partitions))
        self.rng.shuffle(self._order)

        # receiver-sorted CSR over the train subgraph: batch extraction
        # touches only the batch's incident edges (O(sum deg))
        order = np.argsort(self.receivers, kind="stable")
        self._csr_senders = self.senders[order]
        deg = np.bincount(self.receivers, minlength=self.n_nodes)
        self._csr_indptr = np.zeros(self.n_nodes + 1, np.int64)
        np.cumsum(deg, out=self._csr_indptr[1:])
        # stamped scratch map: avoids an O(N) reset per batch
        self._map_local = np.zeros(self.n_nodes, np.int64)
        self._map_gen = np.zeros(self.n_nodes, np.int64)
        self._gen = 0
        self._tables = {}
        if use_pp:
            self.features = self._precalc(self.features)

    def csr_subgraph(self, node_ids: np.ndarray):
        """Induced subgraph of ``node_ids``: ``(senders, receivers)``
        relabeled to [0, len(node_ids)) in node_ids order."""
        ptr, cs = self._csr_indptr, self._csr_senders
        lo, hi = ptr[node_ids], ptr[node_ids + 1]
        cnt = hi - lo
        total = int(cnt.sum())
        if total == 0:
            z = np.zeros(0, np.int64)
            return z, z
        starts = np.zeros(len(node_ids), np.int64)
        np.cumsum(cnt[:-1], out=starts[1:])
        idx = np.repeat(lo - starts, cnt) + np.arange(total)
        dst_local = np.repeat(np.arange(len(node_ids), dtype=np.int64), cnt)
        src_global = cs[idx]
        self._gen += 1
        self._map_local[node_ids] = np.arange(len(node_ids))
        self._map_gen[node_ids] = self._gen
        keep = self._map_gen[src_global] == self._gen
        return self._map_local[src_global[keep]], dst_local[keep]

    def _with_bucketed_tiles(self, g: Graph) -> Graph:
        """Layouts with job or slot counts padded to geometric buckets
        (cluster batch nodes are already cluster-grouped, so no extra
        locality reorder)."""
        gr = BUCKET_GROWTH
        if self.tile_mode == "gather":
            from gist_tpu_torch.graph import _build_tiled_pair, pad_tiled_csr
            tiled, tiled_t = _build_tiled_pair(g)
            tiled, tiled_t = (
                pad_tiled_csr(t, bucket_size(t.senders.shape[0], gr, 1024),
                              bucket_size(max(t.max_chunks, 1), gr, 1))
                for t in (tiled, tiled_t))
            return g.replace(tiled=tiled, tiled_t=tiled_t)
        from gist_tpu_torch.graph import _build_dedup_tiles, pad_dedup_tiles
        e = g.n_edges
        s, r = g.senders[:e].numpy(), g.receivers[:e].numpy()
        t_s, t_r = g.t_senders[:e].numpy(), g.t_receivers[:e].numpy()
        d = _build_dedup_tiles(s, r, g.n_nodes, reorder=False)
        d_t = None if d is None else _build_dedup_tiles(
            t_s, t_r, g.n_nodes, reorder=False)
        if d is None or d_t is None:
            return g
        d = pad_dedup_tiles(d, bucket_size(int(d.w_blocks.shape[0]), gr, 8),
                            bucket_size(d.max_jobs, gr, 4))
        d_t = pad_dedup_tiles(
            d_t, bucket_size(int(d_t.w_blocks.shape[0]), gr, 8),
            bucket_size(d_t.max_jobs, gr, 4))
        return g.replace(dedup=d, dedup_t=d_t)

    def _precalc(self, feats: np.ndarray) -> np.ndarray:
        """``[X || (A X) * 1/deg]`` on the train subgraph.  The JAX
        package sums ``A X`` with ``np.add.at`` in float64, edge by edge.
        Here the receiver-sorted CSR index (a stable sort, so each row's
        edges stay in edge order, duplicates kept) with unit weights
        times X in float64 adds the same terms in the same order, so the
        arrays are equal, at a fraction of ``np.add.at``'s time on a
        large train subgraph."""
        import scipy.sparse as sp
        a = sp.csr_matrix((np.ones(len(self._csr_senders)),
                           self._csr_senders, self._csr_indptr),
                          shape=(self.n_nodes, self.n_nodes))
        agg = a @ feats.astype(np.float64)
        deg = np.bincount(self.receivers, minlength=self.n_nodes
                          ).astype(np.float64)
        inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
        return np.concatenate(
            [feats, (agg * inv[:, None]).astype(np.float32)], axis=1)

    def __len__(self) -> int:
        return self.psize // self.batch_size

    def _epoch_ids(self) -> Iterator[np.ndarray]:
        """One epoch of per-batch node-id arrays; advances the cluster
        order."""
        order = self._order.copy()
        self.rng.shuffle(self._order)
        for i in range(len(self)):
            ids = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield np.concatenate([self.partitions[j] for j in ids])

    def iter_node_ids(self) -> Iterator[np.ndarray]:
        """Endless stream of batch node-id arrays, reshuffling between
        epochs."""
        while True:
            yield from self._epoch_ids()

    def __iter__(self) -> Iterator[ClusterBatch]:
        for node_ids in self._epoch_ids():
            yield self.make_batch(node_ids)

    @staticmethod
    def resolve_batch(batch: ClusterBatch, tables):
        """(graph, feats, labels, mask) of a batch in either form; the
        ids form gathers rows from ``tables`` on their device."""
        if batch.node_ids is None:
            return batch.graph, batch.features, batch.labels, batch.train_mask
        ft, lt, mt = tables
        ids = batch.node_ids
        return (batch.graph, ft.index_select(0, ids), lt.index_select(0, ids),
                mt.index_select(0, ids))

    def tables(self, device="cpu"):
        """(features, labels, train_mask) over the train subgraph with a
        zero row appended, on ``device`` — the gather target of ids-form
        batches.  Built once per device."""
        key = str(device)
        if key not in self._tables:
            f = np.concatenate(
                [self.features,
                 np.zeros((1, self.features.shape[1]), np.float32)])
            lab = np.concatenate(
                [self.labels,
                 np.zeros((1,) + self.labels.shape[1:], self.labels.dtype)])
            m = np.concatenate([self.train_mask, np.zeros(1, bool)])
            self._tables[key] = tuple(
                torch.from_numpy(a).to(device) for a in (f, lab, m))
        return self._tables[key]

    def make_batch(self, node_ids: np.ndarray,
                   node_pad: Optional[int] = None,
                   edge_pad: Optional[int] = None,
                   edges: Optional[tuple] = None,
                   ids_only: bool = False) -> ClusterBatch:
        """``edges`` passes a precomputed ``csr_subgraph`` result;
        ``ids_only=True`` produces the ids batch form."""
        node_ids = np.asarray(node_ids, dtype=np.int64)
        s, r = edges if edges is not None else self.csr_subgraph(node_ids)
        n = len(node_ids)
        n_pad = node_pad or bucket_size(n, BUCKET_GROWTH)
        e_pad = edge_pad or bucket_size(max(len(s), 1), BUCKET_GROWTH)
        g = graph_from_edges(s, r, n_pad, pad_to=e_pad)
        tiles = self.tiles
        if tiles is None:
            from gist_tpu_torch.ops.spmm import tiles_wanted
            tiles = tiles_wanted() and len(s) >= TILES_MIN_EDGES
        if tiles:
            g = self._with_bucketed_tiles(g)

        if ids_only:
            ids = np.full(n_pad, self.n_nodes, np.int32)  # -> zero row
            ids[:n] = node_ids
            return ClusterBatch(
                graph=g, features=None, labels=None, train_mask=None,
                n_real_nodes=n, n_real_edges=len(s),
                node_ids=torch.from_numpy(ids))

        feats = np.zeros((n_pad, self.features.shape[1]), np.float32)
        feats[:n] = self.features[node_ids]
        labels = np.zeros((n_pad,) + self.labels.shape[1:],
                          self.labels.dtype)
        labels[:n] = self.labels[node_ids]
        mask = np.zeros((n_pad,), bool)
        mask[:n] = self.train_mask[node_ids]
        return ClusterBatch(
            graph=g, features=torch.from_numpy(feats),
            labels=torch.from_numpy(labels), train_mask=torch.from_numpy(mask),
            n_real_nodes=n, n_real_edges=len(s))
