"""Graph container and the block-dense dedup layout, as torch tensors.

A graph is a padded receiver-sorted COO edge list plus its CSR row
pointers and the transpose (sender-sorted) view used by the backward
pass (``gist_tpu/graph.py:617``).  Padding edges carry
``receivers == n_nodes``; every consumer drops them.

The host builders are numpy and produce the same arrays as the JAX
package for the same inputs; the containers hold CPU tensors that a
caller moves with ``.to(device)``.  Of the JAX package's layouts only
the flat dedup layout (``DedupTiles``) is ported: the chunked, split
and v1 gather layouts wait for the slices that port their kernels.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class DedupTiles:
    """Block-dense dedup layout consumed by the dedup SpMM kernel.

    Each destination tile of ``tile_rows`` rows lists its unique senders
    once (``u_senders``, padded to a multiple of ``cu`` per tile), and
    the tile's adjacency becomes dense int8 count blocks
    ``w_blocks[j] : (TN, CU)`` paired with the j-th CU-slot block of
    unique senders, so ``out[tile i] = sum_{j in jobs(i)} W_j @ x[u_j]``.
    ``pos[v]`` (when set) is node v's row in the kernel's output order
    (nodes relabeled by a locality partition).  Padding slots point at
    row 0 with all-zero W columns; padding jobs (``pad_dedup_tiles``)
    lie past ``job_offsets[-1]`` and are never read.
    """

    u_senders: torch.Tensor    # (U_pad,) int32 x row per unique slot
    w_blocks: torch.Tensor     # (J, TN, CU) int8 per-job count blocks
    job_offsets: torch.Tensor  # (num_tiles + 1,) int32 job index per tile
    pos: Optional[torch.Tensor]  # (N,) int32 node -> output row, or None
    tile_rows: int
    cu: int
    max_jobs: int

    @property
    def num_tiles(self) -> int:
        return self.job_offsets.shape[0] - 1

    def to(self, device) -> "DedupTiles":
        return dataclasses.replace(
            self, u_senders=self.u_senders.to(device),
            w_blocks=self.w_blocks.to(device),
            job_offsets=self.job_offsets.to(device),
            pos=None if self.pos is None else self.pos.to(device))


def _locality_order(senders: np.ndarray, receivers: np.ndarray,
                    n_nodes: int, tile_rows: int, seed: int = 0):
    """Tile-sized cluster ordering (refined multilevel partition) so a
    dst tile's senders are maximally repeated; returns (perm, pos)."""
    psize = max(2, -(-n_nodes // tile_rows))
    from gist_tpu_torch.partition import get_partition_list
    parts = get_partition_list(senders, receivers, n_nodes, psize, seed=seed)
    perm = np.concatenate([p for p in parts if len(p)])
    pos = np.empty(n_nodes, dtype=np.int64)
    pos[perm] = np.arange(n_nodes)
    return perm, pos


def pad_dedup_tiles(d: DedupTiles, jobs_to: int,
                    max_jobs_to: int) -> DedupTiles:
    """Pad a layout to a bucketed job count (``gist_tpu/graph.py:250``).
    ``job_offsets`` is untouched, so the padding jobs are never read."""
    w = d.w_blocks.numpy()
    u = d.u_senders.numpy()
    jobs_to = max(jobs_to, w.shape[0])
    extra = jobs_to - w.shape[0]
    if extra:
        w = np.concatenate(
            [w, np.zeros((extra, d.tile_rows, d.cu), np.int8)], axis=0)
        u = np.concatenate([u, np.zeros(extra * d.cu, np.int32)])
    return dataclasses.replace(
        d, w_blocks=torch.from_numpy(w), u_senders=torch.from_numpy(u),
        max_jobs=max(d.max_jobs, max_jobs_to))


def _dedup_tile_scan(senders: np.ndarray, receivers: np.ndarray,
                     n_nodes: int, tile_rows: int, cu: int,
                     reorder: bool, seed: int):
    """Host-side build of the dedup layout: per destination tile, the
    padded unique-sender list and int8 count blocks, from one global
    sort over (tile, sender) pairs.  Returns (u_flat, w_flat,
    job_offsets, pos) or None when there is no edge or an int8 count
    would overflow (extreme multigraph)."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    pos = None
    if reorder and n_nodes > 2 * tile_rows:
        _, pos = _locality_order(senders, receivers, n_nodes, tile_rows,
                                 seed=seed)
        r = pos[receivers]
    else:
        r = receivers
    if len(senders) == 0:
        return None
    num_tiles = -(-n_nodes // tile_rows)
    tile_of = r // tile_rows

    # one global unique over (tile, sender) pairs
    k = tile_of * n_nodes + senders
    uk, inv_all = np.unique(k, return_inverse=True)
    u_tile = (uk // n_nodes).astype(np.int64)
    u_node = (uk % n_nodes).astype(np.int64)
    u_cnt = np.bincount(u_tile, minlength=num_tiles)        # U_t per tile
    u_start = np.zeros(num_tiles + 1, dtype=np.int64)
    np.cumsum(u_cnt, out=u_start[1:])
    jobs_per_tile = -(-u_cnt // cu)
    job_offsets = np.zeros(num_tiles + 1, dtype=np.int64)
    np.cumsum(jobs_per_tile, out=job_offsets[1:])
    total_jobs = int(job_offsets[-1])
    if total_jobs == 0:
        return None

    # scatter unique sender ids into the cu-padded flat u array
    pos_in_tile = np.arange(len(uk), dtype=np.int64) - u_start[u_tile]
    u_slot = ((job_offsets[u_tile] + pos_in_tile // cu) * cu
              + pos_in_tile % cu)
    u_flat = np.zeros(total_jobs * cu, dtype=np.int32)
    u_flat[u_slot] = u_node

    # per-edge W flat index -> run-length-encoded counts
    local_row = r - tile_of * tile_rows
    e_upos = pos_in_tile[inv_all]                 # edge's u index in tile
    w_idx = (((job_offsets[tile_of] + e_upos // cu) * tile_rows
              + local_row) * cu + e_upos % cu)
    del k, inv_all, e_upos, local_row
    w_idx.sort(kind="stable")
    boundary = np.empty(len(w_idx), dtype=bool)
    boundary[0] = True
    np.not_equal(w_idx[1:], w_idx[:-1], out=boundary[1:])
    starts = np.nonzero(boundary)[0]
    cnts = np.diff(np.append(starts, len(w_idx)))
    if cnts.max(initial=0) > 127:
        return None  # int8 count overflow
    w_flat = np.zeros(total_jobs * tile_rows * cu, dtype=np.int8)
    w_flat[w_idx[starts]] = cnts.astype(np.int8)
    w_flat = w_flat.reshape(total_jobs, tile_rows, cu)
    return u_flat, w_flat, job_offsets, pos


def _build_dedup_tiles(senders: np.ndarray, receivers: np.ndarray,
                       n_nodes: int, *, tile_rows: int = 128, cu: int = 1024,
                       reorder: bool = True, seed: int = 0,
                       max_w_bytes: int = 512 * 2 ** 20,
                       ) -> Optional[DedupTiles]:
    """Host-side build of the flat layout; None when it would be
    counterproductive (W blocks too large, count overflow)."""
    scan = _dedup_tile_scan(senders, receivers, n_nodes, tile_rows, cu,
                            reorder, seed)
    if scan is None:
        return None
    u_flat, w_flat, job_offsets, pos = scan
    if w_flat.nbytes > max_w_bytes:
        return None
    return DedupTiles(
        u_senders=torch.from_numpy(u_flat),
        w_blocks=torch.from_numpy(w_flat),
        job_offsets=torch.from_numpy(job_offsets.astype(np.int32)),
        pos=None if pos is None else torch.from_numpy(pos.astype(np.int32)),
        tile_rows=tile_rows, cu=cu,
        max_jobs=int(np.diff(job_offsets).max()))


@dataclass(frozen=True)
class Graph:
    """Padded COO+CSR graph (topology only; node features travel
    separately).  Aggregation semantics: output row i sums over the
    senders of the edges whose receiver is i."""

    senders: torch.Tensor      # (E_pad,) int32 source node of each edge
    receivers: torch.Tensor    # (E_pad,) int32 dest node; padding == n_nodes
    indptr: torch.Tensor       # (N+1,) int32 CSR offsets over receivers
    in_degrees: torch.Tensor   # (N,) float32 true in-degree
    out_degrees: torch.Tensor  # (N,) float32 true out-degree
    t_senders: torch.Tensor    # (E_pad,) transpose view: receivers re-sorted
    t_receivers: torch.Tensor  # (E_pad,) senders re-sorted (the segment key)
    t_indptr: torch.Tensor     # (N+1,) int32 CSR offsets over t_receivers
    n_nodes: int
    n_edges: int
    dedup: Optional[DedupTiles] = None    # forward dedup layout
    dedup_t: Optional[DedupTiles] = None  # transpose layout (backward)

    def replace(self, **kw) -> "Graph":
        return dataclasses.replace(self, **kw)

    def transpose(self) -> "Graph":
        """Graph of A^T (senders/receivers swapped), sharing buffers."""
        return Graph(
            senders=self.t_senders, receivers=self.t_receivers,
            indptr=self.t_indptr, in_degrees=self.out_degrees,
            out_degrees=self.in_degrees, t_senders=self.senders,
            t_receivers=self.receivers, t_indptr=self.indptr,
            n_nodes=self.n_nodes, n_edges=self.n_edges,
            dedup=self.dedup_t, dedup_t=self.dedup)

    def to(self, device) -> "Graph":
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self)}
        for k, v in fields.items():
            if isinstance(v, (torch.Tensor, DedupTiles)):
                fields[k] = v.to(device)
        return Graph(**fields)

    @property
    def n_edges_padded(self) -> int:
        return self.senders.shape[0]

    def with_tiles(self) -> "Graph":
        """Return a copy carrying the flat dedup layouts (forward and
        transpose), rebuilt on the host from the edge arrays; a no-op if
        present.  Where the JAX package would fall back to its chunked
        or v1 layout, this raises, as those layouts are not ported."""
        if self.dedup is not None:
            return self
        if self.n_edges > 16 * 2 ** 20:
            raise NotImplementedError(
                "graphs above 16M edges take the chunked dedup layout, "
                "which a later slice ports")
        e = self.n_edges
        s, r = self.senders[:e].numpy(), self.receivers[:e].numpy()
        t_s, t_r = self.t_senders[:e].numpy(), self.t_receivers[:e].numpy()
        d = _build_dedup_tiles(s, r, self.n_nodes)
        d_t = None if d is None else _build_dedup_tiles(t_s, t_r,
                                                        self.n_nodes)
        if d is None or d_t is None:
            raise NotImplementedError(
                "no flat dedup layout for this graph; the JAX package "
                "falls back to the v1 gather layout, which a later slice "
                "ports")
        return self.replace(dedup=d, dedup_t=d_t)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Graph(n_nodes={self.n_nodes}, n_edges={self.n_edges}, "
                f"padded={self.n_edges_padded})")


def graph_from_edges(senders, receivers, n_nodes: int, *,
                     pad_to: Optional[int] = None,
                     tiles: bool = False) -> Graph:
    """Build a receiver-sorted padded Graph (CPU tensors) from a raw COO
    edge list; host-side numpy preprocessing."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    if senders.shape != receivers.shape or senders.ndim != 1:
        raise ValueError("senders and receivers must be 1-D and equal length")
    n_edges = int(senders.shape[0])

    order = np.argsort(receivers, kind="stable")
    senders = senders[order]
    receivers = receivers[order]

    e_pad = pad_to if pad_to is not None else _round_up(max(n_edges, 1), 8)
    if e_pad < n_edges:
        raise ValueError(f"pad_to={e_pad} < n_edges={n_edges}")
    pad = e_pad - n_edges
    # padding senders point at node 0 (any valid id); padding receivers
    # at n_nodes, which every aggregation drops
    senders_p = np.concatenate([senders, np.zeros(pad, dtype=np.int64)])
    receivers_p = np.concatenate([receivers,
                                  np.full(pad, n_nodes, dtype=np.int64)])

    counts = np.bincount(receivers, minlength=n_nodes)[:n_nodes]
    out_counts = np.bincount(senders, minlength=n_nodes)[:n_nodes]
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])

    # transpose view: edges (r -> s) sorted by s
    t_order = np.argsort(senders, kind="stable")
    t_receivers = senders[t_order]
    t_senders = receivers[t_order]
    t_senders_p = np.concatenate([t_senders, np.zeros(pad, dtype=np.int64)])
    t_receivers_p = np.concatenate(
        [t_receivers, np.full(pad, n_nodes, dtype=np.int64)])
    t_indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(out_counts, out=t_indptr[1:])

    def conv(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt))

    g = Graph(
        senders=conv(senders_p, np.int32),
        receivers=conv(receivers_p, np.int32),
        indptr=conv(indptr, np.int32),
        in_degrees=conv(counts, np.float32),
        out_degrees=conv(out_counts, np.float32),
        t_senders=conv(t_senders_p, np.int32),
        t_receivers=conv(t_receivers_p, np.int32),
        t_indptr=conv(t_indptr, np.int32),
        n_nodes=int(n_nodes),
        n_edges=n_edges,
    )
    if tiles:
        g = g.with_tiles()
    return g


def subgraph(senders, receivers, node_ids, n_nodes: int):
    """Node-induced subgraph with relabeled ids; returns (sub_senders,
    sub_receivers, node_ids), edges relabeled to [0, len(node_ids))."""
    node_ids = np.asarray(node_ids, dtype=np.int64)
    mapping = np.full(n_nodes, -1, dtype=np.int64)
    mapping[node_ids] = np.arange(len(node_ids), dtype=np.int64)
    s = mapping[np.asarray(senders, dtype=np.int64)]
    r = mapping[np.asarray(receivers, dtype=np.int64)]
    keep = (s >= 0) & (r >= 0)
    return s[keep], r[keep], node_ids
