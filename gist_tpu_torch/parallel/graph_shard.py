"""Edge-partitioned multi-rank SpMM with the boundary halo exchange
(``gist_tpu/parallel/graph_shard.py``).

One graph's nodes are partitioned over the ``graph`` dim of a mesh; the
rank at position d owns a contiguous relabelled node range, its nodes'
features and every edge whose *receiver* it owns.  Aggregation:

  1. each rank gathers the boundary rows its peers need
     (``ring_send_idx``, built on the host);
  2. the halo moves around a *ring*: one send and one receive per
     non-empty shift k, each padded to that shift's own largest block;
  3. interior edges (sender and receiver on this rank) aggregate while
     the halo is in flight, through K1 (``ops/dedup_spmm.py``) on the
     rank's interior dedup layout when the graph carries one (its
     transpose layout in the backward), else through S1
     (``ops/segment_csr.py``) over their CSR; the boundary edges then
     aggregate the received rows through S1.

Every sum of the ring aggregation runs in a fixed order: S1 walks the
CSR offsets of each edge list, in receiver order for the forward and in
sender order for the backward (:class:`EdgeCSR`, built once on the host
by :func:`ring_device_arrays`), and the halo cotangents that come back
are added into the rows that were sent by S1 over those rows' CSR.

The host build (:func:`build_sharded_graph`) is the JAX package's numpy
code, so every array equals JAX's; arrays keep their leading (D,) axis
and each rank takes its own slice (:func:`ring_device_arrays`).  Every
rank builds the same graph from the same edges.  The port aggregates
through the ring only; the all_to_all layout arrays (``senders``,
``send_idx``, ...) stay for parity with JAX's build and for
:meth:`ShardedGraph.comm_stats`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gist_tpu_torch.graph import DedupTiles
from gist_tpu_torch.ops import segment_csr as csr
from gist_tpu_torch.parallel import comm


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class ShardedGraph:
    """Host (CPU) int32/float32 tensors with a leading (D,) device axis.
    Sender indices address the per-rank ``[x_local (n_loc_pad) ; halo]``
    stack; the halo layout depends on the exchange (ring: the blocks of
    the kept shifts in shift order; all_to_all: D blocks of
    ``halo_pad``)."""

    senders: torch.Tensor      # (D, E_pad) a2a halo layout
    receivers: torch.Tensor    # (D, E_pad); padding == n_loc_pad
    send_idx: torch.Tensor     # (D, D, halo_pad) rows to send (a2a)
    ring_send_idx: Tuple[torch.Tensor, ...]  # per kept shift: (D, pad_k)
    in_degrees: torch.Tensor   # (D, n_loc_pad) true in-degree
    out_degrees: torch.Tensor  # (D, n_loc_pad)
    node_perm: torch.Tensor    # (N,) original -> shard order
    int_senders: torch.Tensor  # (D, Ei_pad) rows of x_local
    int_receivers: torch.Tensor
    bnd_senders: torch.Tensor       # (D, Eb_pad) a2a halo positions
    bnd_receivers: torch.Tensor
    ring_bnd_senders: torch.Tensor  # (D, Eb_pad) ring halo positions
    n_nodes: int
    n_devices: int
    n_loc_pad: int
    halo_pad: int
    n_edges: int
    ideal_halo_rows: int
    ring_shifts: Tuple[int, ...] = ()
    # per-shard dedup layouts of the interior edges (leading (D,) axis,
    # padded to common shapes) and their transposes; None without tiles
    int_dedup: Optional[DedupTiles] = None
    int_dedup_t: Optional[DedupTiles] = None
    # (D, n_loc_pad): 1.0 on real rows, 0.0 on padding
    row_valid: Optional[torch.Tensor] = None
    # whether the build was asked for the interior layouts (explicitly or
    # by default); with it and no layout, a shard's build bailed
    tiles_requested: bool = False

    @property
    def total_rows(self) -> int:
        return self.n_devices * self.n_loc_pad

    @property
    def ring_pads(self) -> Tuple[int, ...]:
        return tuple(int(a.shape[1]) for a in self.ring_send_idx)

    def comm_stats(self, f: int = 1, itemsize: int = 4) -> dict:
        """Rows and bytes sent per aggregation, against the ideal (each
        needed boundary row moved exactly once)."""
        D = self.n_devices
        ideal = self.ideal_halo_rows
        ring_rows = D * sum(self.ring_pads)
        a2a_rows = D * D * self.halo_pad
        row_b = f * itemsize
        return {
            "ideal_rows": ideal,
            "ring_rows": ring_rows,
            "a2a_rows": a2a_rows,
            "ring_waste": ring_rows / max(ideal, 1),
            "a2a_waste": a2a_rows / max(ideal, 1),
            "ideal_bytes": ideal * row_b,
            "ring_bytes": ring_rows * row_b,
            "a2a_bytes": a2a_rows * row_b,
        }

    def projected_scaling(self, t1_agg_s: float, f: int,
                          itemsize: int = 4, *, link_bytes_per_s: float,
                          halo_itemsize: Optional[int] = None) -> dict:
        """The JAX package's projection of the D-device edges/s scaling
        of one aggregation from a one-device time ``t1_agg_s``: the
        slowest rank's step is ``max(t_interior, t_wire) + t_boundary``
        (overlapped) or ``t_compute + t_wire`` (serial), compute scaling
        with the rank's edge share and the wire with the rows it sends
        per ring shift at ``link_bytes_per_s``.  Both rates are the
        caller's: a one-device time measured on the card, and the rate
        of the link the ranks would use, each named where it is
        reported.  ``halo_itemsize`` (default ``itemsize``) is the
        bytes of a halo element on the wire."""
        h_item = itemsize if halo_itemsize is None else halo_itemsize
        D = self.n_devices
        E = max(self.n_edges, 1)
        recv = self.receivers.numpy()
        edges_dev = (recv < self.n_loc_pad).sum(axis=1)
        bnd = self.bnd_receivers.numpy()
        bnd_dev = (bnd < self.n_loc_pad).sum(axis=1)
        worst = int(edges_dev.argmax())
        t_edge = t1_agg_s / E
        t_comp = float(edges_dev[worst]) * t_edge
        t_bnd = float(bnd_dev[worst]) * t_edge
        t_int = t_comp - t_bnd
        wire_rows = sum(self.ring_pads)
        t_wire = wire_rows * f * h_item / link_bytes_per_s
        t_overlap = max(t_int, t_wire) + t_bnd
        t_serial = t_comp + t_wire
        ideal = t1_agg_s / D
        return {
            "n_devices": D,
            "edges_per_device_max": int(edges_dev.max()),
            "edges_per_device_mean": float(edges_dev.mean()),
            "edge_balance": float(edges_dev.max() * D / E),
            "wire_rows_per_device": int(wire_rows),
            "wire_bytes_per_device": int(wire_rows * f * h_item),
            "t_compute_s": t_comp,
            "t_wire_s": t_wire,
            "t_step_overlap_s": t_overlap,
            "t_step_serial_s": t_serial,
            "efficiency_overlap": ideal / t_overlap,
            "efficiency_serial": ideal / t_serial,
            "speedup_overlap": t1_agg_s / t_overlap,
        }


def _chain_order_parts(senders, receivers, n_nodes,
                       parts: List[np.ndarray]) -> List[np.ndarray]:
    """Renumber parts so that heavily communicating pairs get nearby
    ranks (a nearest-neighbour chain over the inter-part edge counts):
    the ring pads per shift, so halo weight on small |i - j| leaves far
    shifts empty."""
    D = len(parts)
    if D <= 2:
        return parts
    owner = np.empty(n_nodes, dtype=np.int64)
    for d, p in enumerate(parts):
        owner[p] = d
    so, ro = owner[np.asarray(senders)], owner[np.asarray(receivers)]
    cross = so != ro
    C = np.bincount(ro[cross] * D + so[cross], minlength=D * D) \
        .reshape(D, D).astype(np.int64)
    C = C + C.T
    # start from the weakest-connected part (an end of the chain)
    order = [int(np.argmin(C.sum(1)))]
    seen = {order[0]}
    while len(order) < D:
        last = order[-1]
        cand = [(int(C[last, j]), -j) for j in range(D) if j not in seen]
        best = -max(cand)[1]
        order.append(best)
        seen.add(best)
    return [parts[j] for j in order]


def _stack_tiles(tiles: List[DedupTiles], n_loc_pad: int) -> DedupTiles:
    """Per-shard layouts padded to one job count and stacked on a
    leading (D,) axis; a shard too small for the locality order gets
    the identity ``pos`` when another has one, so the leaves stack."""
    from gist_tpu_torch.graph import pad_dedup_tiles
    jb = max(int(t.w_blocks.shape[0]) for t in tiles)
    mj = max(t.max_jobs for t in tiles)
    tiles = [pad_dedup_tiles(t, jb, mj) for t in tiles]
    if any(t.pos is not None for t in tiles):
        ident = torch.arange(n_loc_pad, dtype=torch.int32)
        tiles = [t if t.pos is not None else dataclasses.replace(t, pos=ident)
                 for t in tiles]
    pos = None if tiles[0].pos is None else torch.stack(
        [t.pos for t in tiles])
    return DedupTiles(
        u_senders=torch.stack([t.u_senders for t in tiles]),
        w_blocks=torch.stack([t.w_blocks for t in tiles]),
        job_offsets=torch.stack([t.job_offsets for t in tiles]),
        pos=pos, tile_rows=tiles[0].tile_rows, cu=tiles[0].cu,
        max_jobs=max(t.max_jobs for t in tiles))


def _build_interior_tiles(int_s: List[np.ndarray], int_r: List[np.ndarray],
                          n_loc_pad: int, seed: int):
    """(forward, transpose) stacked interior layouts, or (None, None)
    when any shard's build bails (no edge, an int8 count overflow, W
    too large)."""
    from gist_tpu_torch.graph import _build_dedup_tiles
    fwd, bwd = [], []
    for s, r in zip(int_s, int_r):
        d = _build_dedup_tiles(s, r, n_loc_pad, seed=seed)
        # the transpose aggregates out[s] += g[r]
        d_t = None if d is None else _build_dedup_tiles(r, s, n_loc_pad,
                                                        seed=seed)
        if d is None or d_t is None:
            return None, None
        fwd.append(d)
        bwd.append(d_t)
    return _stack_tiles(fwd, n_loc_pad), _stack_tiles(bwd, n_loc_pad)


def build_sharded_graph(senders, receivers, n_nodes: int, n_devices: int,
                        *, parts: Optional[List[np.ndarray]] = None,
                        seed: int = 0,
                        interior_tiles: Optional[bool] = None,
                        ) -> ShardedGraph:
    """Host-side build (``gist_tpu/parallel/graph_shard.py:246``).
    ``parts`` (optional) is a list of ``n_devices`` disjoint node-id
    arrays; by default the refined multilevel partitioner's.
    ``interior_tiles=None`` builds the interior dedup layouts when the
    active aggregation backend could use them
    (:func:`gist_tpu_torch.ops.spmm.tiles_wanted`: ``auto`` with a
    card, or ``dedup``)."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    D = n_devices
    if parts is None:
        from gist_tpu_torch.partition import get_partition_list
        parts = get_partition_list(senders, receivers, n_nodes, D, seed=seed)
    assert len(parts) == D
    parts = _chain_order_parts(senders, receivers, n_nodes, parts)

    # relabel: rank d owns ids [d*n_loc_pad, d*n_loc_pad + len(parts[d]))
    n_loc_pad = _round_up(max(max(len(p) for p in parts), 1), 8)
    perm = np.full(n_nodes, -1, dtype=np.int64)       # old -> new
    owner = np.empty(n_nodes, dtype=np.int64)
    local_of = np.empty(n_nodes, dtype=np.int64)
    for d, p in enumerate(parts):
        perm[p] = d * n_loc_pad + np.arange(len(p))
        owner[p] = d
        local_of[p] = np.arange(len(p))
    assert (perm >= 0).all(), "parts must cover all nodes"

    s_owner = owner[senders]
    e_owner = owner[receivers]
    cross = s_owner != e_owner

    # halo needs: one sort over the cross edges,
    # key = ((dst_dev * D) + src_dev) * n_loc_pad + src_local
    ckey = ((e_owner[cross] * D + s_owner[cross]) * n_loc_pad
            + local_of[senders[cross]])
    uniq = np.unique(ckey)
    u_pair = uniq // n_loc_pad                   # dst*D + src
    u_local = uniq % n_loc_pad
    pair_start = np.searchsorted(u_pair, np.arange(D * D))
    pair_end = np.searchsorted(u_pair, np.arange(D * D), side="right")
    pair_cnt = (pair_end - pair_start).reshape(D, D)   # [i, j] = |need i<-j|
    ideal_halo_rows = int(len(uniq))

    # position of every cross edge's sender in its pair's need list
    e_upos = np.searchsorted(uniq, ckey)
    e_pair_pos = e_upos - pair_start[ckey // n_loc_pad]

    # a2a layout: every pair's block padded to the global largest
    halo_pad = _round_up(max(int(pair_cnt.max()), 1), 8)
    send_idx = np.zeros((D, D, halo_pad), dtype=np.int64)
    for i in range(D):
        for j in range(D):
            a, b = pair_start[i * D + j], pair_end[i * D + j]
            send_idx[j, i, :b - a] = u_local[a:b]

    # ring layout: shift k moves need[(j+k)%D <- j], padded per shift;
    # shifts with no needed row are dropped
    ring_shifts = []
    ring_send = []
    ring_off = np.zeros(D, dtype=np.int64)       # halo offset of shift k
    acc = 0
    for k in range(1, D):
        pk = max(int(pair_cnt[(j + k) % D, j]) for j in range(D))
        if pk == 0:
            continue
        blk = np.zeros((D, pk), dtype=np.int64)
        for j in range(D):
            i = (j + k) % D
            a, b = pair_start[i * D + j], pair_end[i * D + j]
            blk[j, :b - a] = u_local[a:b]
        ring_shifts.append(k)
        ring_send.append(blk)
        ring_off[k] = acc
        acc += pk

    # per-rank edge lists with remapped senders
    e_local = np.where(cross, -1, local_of[senders])
    src_j = s_owner
    a2a_halo_pos = np.zeros(len(senders), dtype=np.int64)
    ring_halo_pos = np.zeros(len(senders), dtype=np.int64)
    if cross.any():
        cj = src_j[cross]
        ci = e_owner[cross]
        a2a_halo_pos[cross] = cj * halo_pad + e_pair_pos
        kshift = (ci - cj) % D
        ring_halo_pos[cross] = ring_off[kshift] + e_pair_pos

    e_pad = _round_up(max(int((e_owner == i).sum()) for i in range(D)) or 1,
                      8)
    s_out = np.zeros((D, e_pad), dtype=np.int64)
    r_out = np.full((D, e_pad), n_loc_pad, dtype=np.int64)
    int_s, int_r, bnd_s, bnd_r, rbnd_s = [], [], [], [], []
    for i in range(D):
        mask_i = e_owner == i
        r_i = local_of[receivers[mask_i]]
        is_local = ~cross[mask_i]
        loc_senders = np.where(is_local, e_local[mask_i],
                               n_loc_pad + a2a_halo_pos[mask_i])
        order = np.argsort(r_i, kind="stable")
        cnt = int(mask_i.sum())
        s_out[i, :cnt] = loc_senders[order]
        r_out[i, :cnt] = r_i[order]
        loc_sorted = is_local[order]
        int_s.append(e_local[mask_i][order][loc_sorted])
        int_r.append(r_i[order][loc_sorted])
        bnd_s.append(a2a_halo_pos[mask_i][order][~loc_sorted])
        bnd_r.append(r_i[order][~loc_sorted])
        rbnd_s.append(ring_halo_pos[mask_i][order][~loc_sorted])

    ei_pad = _round_up(max(len(a) for a in int_s) or 1, 8)
    eb_pad = _round_up(max(len(a) for a in bnd_s) or 1, 8)
    int_s_out = np.zeros((D, ei_pad), dtype=np.int64)
    int_r_out = np.full((D, ei_pad), n_loc_pad, dtype=np.int64)
    bnd_s_out = np.zeros((D, eb_pad), dtype=np.int64)
    bnd_r_out = np.full((D, eb_pad), n_loc_pad, dtype=np.int64)
    rbnd_s_out = np.zeros((D, eb_pad), dtype=np.int64)
    for i in range(D):
        int_s_out[i, :len(int_s[i])] = int_s[i]
        int_r_out[i, :len(int_r[i])] = int_r[i]
        bnd_s_out[i, :len(bnd_s[i])] = bnd_s[i]
        bnd_r_out[i, :len(bnd_r[i])] = bnd_r[i]
        rbnd_s_out[i, :len(rbnd_s[i])] = rbnd_s[i]

    # degrees in shard order (true degrees of the full graph)
    in_deg = np.bincount(receivers, minlength=n_nodes).astype(np.float32)
    out_deg = np.bincount(senders, minlength=n_nodes).astype(np.float32)
    in_deg_sh = np.zeros((D, n_loc_pad), np.float32)
    out_deg_sh = np.zeros((D, n_loc_pad), np.float32)
    row_valid = np.zeros((D, n_loc_pad), np.float32)
    for d, p in enumerate(parts):
        in_deg_sh[d, :len(p)] = in_deg[p]
        out_deg_sh[d, :len(p)] = out_deg[p]
        row_valid[d, :len(p)] = 1.0

    if interior_tiles is None:
        from gist_tpu_torch.ops.spmm import tiles_wanted
        interior_tiles = tiles_wanted()
    int_dedup = int_dedup_t = None
    if interior_tiles:
        int_dedup, int_dedup_t = _build_interior_tiles(
            int_s, int_r, n_loc_pad, seed)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))

    return ShardedGraph(
        senders=i32(s_out), receivers=i32(r_out), send_idx=i32(send_idx),
        ring_send_idx=tuple(i32(b) for b in ring_send),
        in_degrees=torch.from_numpy(in_deg_sh),
        out_degrees=torch.from_numpy(out_deg_sh),
        node_perm=i32(perm),
        int_senders=i32(int_s_out), int_receivers=i32(int_r_out),
        bnd_senders=i32(bnd_s_out), bnd_receivers=i32(bnd_r_out),
        ring_bnd_senders=i32(rbnd_s_out),
        n_nodes=n_nodes, n_devices=D, n_loc_pad=n_loc_pad,
        halo_pad=halo_pad, n_edges=int(senders.shape[0]),
        ideal_halo_rows=ideal_halo_rows, ring_shifts=tuple(ring_shifts),
        int_dedup=int_dedup, int_dedup_t=int_dedup_t,
        row_valid=torch.from_numpy(row_valid),
        tiles_requested=bool(interior_tiles))


def shard_rows(sg: ShardedGraph, a) -> np.ndarray:
    """Node-order rows permuted and zero-padded into shard order:
    (D * n_loc_pad, ...) on the host."""
    a = np.asarray(a)
    out = np.zeros((sg.total_rows,) + a.shape[1:], a.dtype)
    out[sg.node_perm.numpy()] = a
    return out


def shard_features(sg: ShardedGraph, x, rank: int,
                   device="cpu") -> torch.Tensor:
    """Rank ``rank``'s (n_loc_pad, F) rows of node features ``x`` in
    shard order, on ``device`` (``gist_tpu/parallel/graph_shard.py:419``
    places every rank's rows at once)."""
    rows = shard_rows(sg, x)[rank * sg.n_loc_pad:(rank + 1) * sg.n_loc_pad]
    return torch.from_numpy(rows).to(device)


def unshard(sg: ShardedGraph, y: torch.Tensor) -> torch.Tensor:
    """Every rank's rows (D * n_loc_pad, F), e.g. from
    :func:`comm.all_gather_stack` flattened, back to node order."""
    return y.index_select(0, sg.node_perm.to(y.device).long())


def gather_unshard(sg: ShardedGraph, y_loc: torch.Tensor,
                   group=None) -> torch.Tensor:
    """The graph dim's rows gathered on every rank, in node order."""
    full = comm.all_gather_stack(y_loc.detach(), group)
    return unshard(sg, full.reshape((-1,) + tuple(y_loc.shape[1:])))


def _slice_tiles(t: DedupTiles, d: int, device) -> DedupTiles:
    return dataclasses.replace(
        t, u_senders=t.u_senders[d].to(device),
        w_blocks=t.w_blocks[d].to(device),
        job_offsets=t.job_offsets[d].to(device),
        pos=None if t.pos is None else t.pos[d].to(device))


class EdgeCSR(NamedTuple):
    """One rank's edge list as S1 reads it: ``indptr`` (rows + 1,) over
    the receivers with ``senders`` in that order (the forward), and
    ``t_indptr`` (sources + 1,) over the senders with ``t_perm`` the
    edges in that order and ``t_receivers`` their receivers (the
    backward).  int32, padding edges past both ends."""
    indptr: torch.Tensor
    senders: torch.Tensor
    t_indptr: torch.Tensor
    t_perm: torch.Tensor
    t_receivers: torch.Tensor


def _offsets(keys: np.ndarray, n: int) -> tuple:
    """(CSR offsets (n + 1,), stable order) of ``keys`` by value; keys
    outside [0, n) fall past the last offset."""
    valid = (keys >= 0) & (keys < n)
    order = np.argsort(np.where(valid, keys, n), kind="stable")
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(keys[valid], minlength=n)[:n], out=indptr[1:])
    return indptr, order


def edge_csr(senders, receivers, n_rows: int, n_src: int,
             device) -> EdgeCSR:
    """The :class:`EdgeCSR` of an edge list sorted by receiver (padding
    receivers ``n_rows``) whose senders address ``n_src`` rows."""
    s = np.asarray(senders, dtype=np.int64)
    r = np.asarray(receivers, dtype=np.int64)
    indptr, _ = _offsets(r, n_rows)
    t_indptr, t_perm = _offsets(np.where(r < n_rows, s, n_src), n_src)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)) \
            .to(device)
    return EdgeCSR(i32(indptr), i32(s), i32(t_indptr), i32(t_perm),
                   i32(r[t_perm]))


def halo_rows(sg: ShardedGraph) -> int:
    """Rows of the halo stack: the kept shifts' blocks, or the 8 zero
    rows that stand in for it without a shift."""
    return sum(sg.ring_pads) or 8


def ring_device_arrays(sg: ShardedGraph, rank: int, device) -> dict:
    """Rank ``rank``'s slice of what the ring aggregation reads, on
    ``device``: the rows it sends per kept shift, its interior and
    boundary edge lists (ring halo positions), and its interior dedup
    layout pair when the graph carries one.  On a card, a graph whose
    interior layouts were asked for but not built (a shard's build
    bailed: no interior edge, an int8 count overflow, W too large)
    raises rather than aggregate without K1; build it with
    ``interior_tiles=False`` to sum through S1 there.  ``int_csr`` and
    ``bnd_csr`` are the interior and boundary edges' :class:`EdgeCSR`
    (the boundary's senders are halo rows); ``send_csr`` the CSR
    offsets over the rank's rows of every row it sends (the kept shifts'
    blocks concatenated, padding slots included) and their order."""
    if torch.device(device).type == "cuda" and sg.tiles_requested \
            and sg.int_dedup is None:
        raise RuntimeError(
            "the sharded graph was asked for its interior dedup layouts "
            "but a shard's build bailed; build it with "
            "interior_tiles=False to aggregate through S1")

    def take(a):
        return a[rank].to(device).long()

    dev = {
        "ring_send": [take(a) for a in sg.ring_send_idx],
        "int_s": take(sg.int_senders), "int_r": take(sg.int_receivers),
        "bnd_s": take(sg.ring_bnd_senders), "bnd_r": take(sg.bnd_receivers),
        "int_csr": edge_csr(sg.int_senders[rank], sg.int_receivers[rank],
                            sg.n_loc_pad, sg.n_loc_pad, device),
        "bnd_csr": edge_csr(sg.ring_bnd_senders[rank],
                            sg.bnd_receivers[rank], sg.n_loc_pad,
                            halo_rows(sg), device),
    }
    sent = np.concatenate([np.zeros(0, np.int64)]
                          + [a[rank].numpy() for a in sg.ring_send_idx])
    send_p, send_perm = _offsets(sent, sg.n_loc_pad)
    dev["send_csr"] = tuple(
        torch.from_numpy(a.astype(np.int32)).to(device)
        for a in (send_p, send_perm))
    if sg.int_dedup is not None:
        dev["int_dedup"] = _slice_tiles(sg.int_dedup, rank, device)
        dev["int_dedup_t"] = _slice_tiles(sg.int_dedup_t, rank, device)
    return dev


def _segment_sum(msgs: torch.Tensor, r: torch.Tensor, n: int,
                 indptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``segment_sum`` of per-edge rows over receivers ``r`` (sorted;
    padding receivers, == n, left out) through S1 in edge order,
    differentiable in ``msgs``; ``indptr`` is r's CSR (from
    :class:`EdgeCSR`), found on the device when not given."""
    if indptr is None:
        indptr = csr.index_csr(r, n)[0]
    return csr.sum_rows(msgs, indptr, r)


def _interior(sg: ShardedGraph, dev: dict, x: torch.Tensor,
              transpose: bool = False) -> torch.Tensor:
    """The interior edges' sum: K1 on the rank's interior layout (the
    transpose layout for the backward) when the bundle carries it, else
    S1 over their CSR (in sender order for the backward)."""
    n = sg.n_loc_pad
    if "int_dedup" in dev:
        from gist_tpu_torch.ops.dedup_spmm import run_dedup
        t = dev["int_dedup_t"] if transpose else dev["int_dedup"]
        return run_dedup(t, x.contiguous(), n)
    e = dev["int_csr"]
    if transpose:
        return csr.segment_csr(e.t_indptr, x.contiguous(), e.t_receivers)
    return csr.segment_csr(e.indptr, x.contiguous(), e.senders)


def _send_blocks(x: torch.Tensor, ring_send, halo_dtype):
    return [x.index_select(0, idx).to(halo_dtype or x.dtype)
            for idx in ring_send]


def _scatter_back(dx: torch.Tensor, dev: dict, received) -> torch.Tensor:
    """Add the halo cotangents that came back into the rows sent: S1
    over the sent rows' CSR (``send_csr``), in the order the blocks were
    sent.  A block's padding slots name row 0 and bring back exact
    zeros."""
    if not received:
        return dx
    indptr, perm = dev["send_csr"]
    return dx + csr.segment_csr(indptr, torch.cat(received).to(dx.dtype),
                                perm)


def _split_halo(g_halo: torch.Tensor, pads, halo_dtype):
    return [b.to(halo_dtype or g_halo.dtype)
            for b in torch.split(g_halo, list(pads))]


def _halo_of(received, x: torch.Tensor) -> torch.Tensor:
    if not received:
        return x.new_zeros((8, x.shape[1]))
    return torch.cat(received).to(x.dtype)


class _RingSumAgg(torch.autograd.Function):
    """``out[r] = sum_{s->r} x[s]`` for one rank's rows: the ring's
    sends and receives are posted first, the interior sum runs while
    they are in flight, then the boundary edges sum the received rows.
    The backward mirrors it: the halo cotangents go back around the
    reverse ring while the interior's transpose sum runs, and are added
    into the rows that were sent."""

    @staticmethod
    def forward(ctx, x, sg, dev, group, halo_dtype):
        ctx.sg, ctx.dev, ctx.group, ctx.halo_dtype = sg, dev, group, \
            halo_dtype
        ring = comm.Ring(_send_blocks(x, dev["ring_send"], halo_dtype),
                         sg.ring_shifts, group)
        interior = _interior(sg, dev, x)
        halo = _halo_of(ring.wait(), x)
        ctx.halo_rows = halo.shape[0]
        bnd = dev["bnd_csr"]
        boundary = csr.segment_csr(bnd.indptr, halo, bnd.senders)
        return interior + boundary

    @staticmethod
    def backward(ctx, g):
        sg, dev = ctx.sg, ctx.dev
        g = g.contiguous()
        bnd = dev["bnd_csr"]
        g_halo = csr.segment_csr(bnd.t_indptr, g, bnd.t_receivers)
        ring = comm.Ring(_split_halo(g_halo[:sum(sg.ring_pads)],
                                     sg.ring_pads, ctx.halo_dtype),
                         sg.ring_shifts, ctx.group, reverse=True)
        dx = _interior(sg, dev, g, transpose=True)
        return _scatter_back(dx, dev, ring.wait()), None, None, None, None


class _RingHalo(torch.autograd.Function):
    """The halo stack in ring order (what ``bnd_s`` indexes), with the
    cotangents sent back around the reverse ring in the backward."""

    @staticmethod
    def forward(ctx, x, sg, dev, group, halo_dtype):
        ctx.sg, ctx.dev, ctx.group, ctx.halo_dtype = sg, dev, group, \
            halo_dtype
        ctx.n_rows = x.shape[0]
        ring = comm.Ring(_send_blocks(x, dev["ring_send"], halo_dtype),
                         sg.ring_shifts, group)
        return _halo_of(ring.wait(), x)

    @staticmethod
    def backward(ctx, g):
        sg = ctx.sg
        ring = comm.Ring(_split_halo(g[:sum(sg.ring_pads)], sg.ring_pads,
                                     ctx.halo_dtype),
                         sg.ring_shifts, ctx.group, reverse=True)
        dx = g.new_zeros((ctx.n_rows, g.shape[1]))
        return _scatter_back(dx, ctx.dev, ring.wait()), None, None, None, \
            None


def ring_halo(sg: ShardedGraph, x_loc: torch.Tensor, dev: dict, group,
              halo_dtype=None) -> torch.Tensor:
    """``_ring_halo``: one send and receive per kept shift, the received
    rows concatenated in shift order ((8, F) zeros without a shift).
    ``dev`` is the rank's :func:`ring_device_arrays`.  ``halo_dtype``
    (e.g. ``torch.bfloat16``) casts the rows on the wire only, both
    ways; they are cast back before use."""
    return _RingHalo.apply(x_loc, sg, dev, group, halo_dtype)


def local_agg_ring(sg: ShardedGraph, x_loc: torch.Tensor, dev: dict, group,
                   halo_dtype=None) -> torch.Tensor:
    """``_local_agg_ring``: the ring halo exchange overlapped with the
    interior sum, then the boundary sum; differentiable in ``x_loc``."""
    return _RingSumAgg.apply(x_loc, sg, dev, group, halo_dtype)


def sharded_aggregate(sg: ShardedGraph, mesh, halo_dtype=None):
    """``agg(x_loc) -> y_loc``: this rank's (n_loc_pad, F) rows of the
    distributed ``out[r] = sum x[s]`` over the mesh's ``graph`` dim, by
    the ring with the interior/boundary overlap
    (:func:`local_agg_ring`).  ``halo_dtype`` (e.g. ``torch.bfloat16``)
    is the wire dtype of the halo."""
    rank = mesh.get_local_rank("graph")
    group = mesh.get_group("graph")
    cache = {}

    def run(x_loc):
        if x_loc.device not in cache:
            cache[x_loc.device] = ring_device_arrays(sg, rank, x_loc.device)
        return local_agg_ring(sg, x_loc, cache[x_loc.device], group,
                              halo_dtype)

    return run
