"""Graph container and the block-dense dedup layout, as torch tensors.

A graph is a padded receiver-sorted COO edge list plus its CSR row
pointers and the transpose (sender-sorted) view used by the backward
pass (``gist_tpu/graph.py:617``).  Padding edges carry
``receivers == n_nodes``; every consumer drops them.

The host builders are numpy and produce the same arrays as the JAX
package for the same inputs; the containers hold CPU tensors that a
caller moves with ``.to(device)``.  Every layout is ported: the dedup
layouts, flat (``DedupTiles``), chunked and split
(``ChunkedDedupTiles``), and the v1 gather layout (``TiledCSR``), which
``with_tiles`` builds on request (``mode="gather"``) and where a dedup
build fails, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


# one flat gather of every unique row beyond this many edges is
# device-memory hostile whatever W's size: ``with_tiles`` goes straight
# to the chunked layout (``gist_tpu/graph.py:688``)
HUGE_EDGES = 16 * 2 ** 20
# default bound on one chunk's unique-row slots
CHUNK_ROWS = 4 * 2 ** 20


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class TiledCSR:
    """The v1 gather layout (``gist_tpu/graph.py:34``): receiver-sorted
    edges re-laid so that each destination tile's segment starts at a
    multiple of ``chunk`` slots.  Padding slots carry the sentinel
    receiver ``num_tiles * tile_rows`` (above every row) and sender 0;
    slots past ``tile_offsets[-1]`` (``pad_tiled_csr``) are never read.
    Within a tile the receivers ascend, so each destination row's slots
    are contiguous.  ``pos_in_other[e]`` is the position of slot e's edge
    in the other layout of a forward/transpose pair (0 for padding
    slots).  The 1024-slot padding is a TPU DMA rule, kept so that the
    arrays stay equal to the JAX package's."""

    senders: torch.Tensor       # (E_t,) int32
    receivers: torch.Tensor     # (E_t,) int32
    tile_offsets: torch.Tensor  # (num_tiles + 1,) int32, multiples of chunk
    tile_rows: int
    chunk: int
    max_chunks: int
    pos_in_other: Optional[torch.Tensor] = None   # (E_t,) int32

    @property
    def num_tiles(self) -> int:
        return self.tile_offsets.shape[0] - 1

    def to(self, device) -> "TiledCSR":
        return dataclasses.replace(
            self, senders=self.senders.to(device),
            receivers=self.receivers.to(device),
            tile_offsets=self.tile_offsets.to(device),
            pos_in_other=None if self.pos_in_other is None
            else self.pos_in_other.to(device))


def _round_up_arr(x: np.ndarray, m: int) -> np.ndarray:
    return ((x + m - 1) // m) * m


def _build_tiled_csr(senders_sorted: np.ndarray,
                     receivers_sorted: np.ndarray, indptr: np.ndarray,
                     n_nodes: int, tile_rows: int = 128, chunk: int = 1024):
    """Re-lay receiver-sorted edges so that each destination tile's
    segment starts at a chunk-aligned offset (``gist_tpu/graph.py:62``).
    Returns the layout and each edge's slot (None without edges)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    num_tiles = -(-n_nodes // tile_rows)
    bounds = np.minimum(np.arange(num_tiles + 1) * tile_rows, n_nodes)
    seg_starts = indptr[bounds[:-1]]
    seg_counts = indptr[bounds[1:]] - seg_starts
    padded = np.maximum(_round_up_arr(seg_counts, chunk), 0)
    offsets = np.zeros(num_tiles + 1, dtype=np.int64)
    np.cumsum(padded, out=offsets[1:])
    total = int(offsets[-1])

    s_out = np.zeros(total, dtype=np.int32)
    r_out = np.full(total, num_tiles * tile_rows, dtype=np.int32)
    dst = None
    if len(senders_sorted):
        tile_of_edge = np.repeat(np.arange(num_tiles), seg_counts)
        within = np.arange(len(senders_sorted)) - seg_starts[tile_of_edge]
        dst = offsets[:-1][tile_of_edge] + within
        s_out[dst] = senders_sorted
        r_out[dst] = receivers_sorted
    tiled = TiledCSR(
        senders=torch.from_numpy(s_out), receivers=torch.from_numpy(r_out),
        tile_offsets=torch.from_numpy(offsets.astype(np.int32)),
        tile_rows=tile_rows, chunk=chunk,
        max_chunks=int(padded.max() // chunk) if num_tiles else 0)
    return tiled, dst


def _link_tiled_pair(fwd: TiledCSR, fwd_dst, t: TiledCSR, t_dst,
                     t_order: np.ndarray, n_edges: int):
    """Fill ``pos_in_other`` on a forward/transpose pair
    (``gist_tpu/graph.py:96``): ``fwd_dst[k]`` is the forward slot of the
    k-th receiver-sorted edge, ``t_dst[k]`` the transpose slot of the
    k-th sender-sorted edge, whose receiver-sorted index is
    ``t_order[k]``."""
    if n_edges == 0 or fwd_dst is None or t_dst is None:
        return fwd, t
    pos_f = np.asarray(fwd_dst, dtype=np.int64)
    pos_t = np.zeros(n_edges, dtype=np.int64)
    pos_t[np.asarray(t_order, dtype=np.int64)] = np.asarray(t_dst,
                                                            dtype=np.int64)
    f_other = np.zeros(fwd.senders.shape[0], dtype=np.int64)
    f_other[pos_f] = pos_t
    t_other = np.zeros(t.senders.shape[0], dtype=np.int64)
    t_other[pos_t] = pos_f
    return (dataclasses.replace(
                fwd, pos_in_other=torch.from_numpy(f_other.astype(np.int32))),
            dataclasses.replace(
                t, pos_in_other=torch.from_numpy(t_other.astype(np.int32))))


def _build_tiled_pair(g: "Graph", tile_rows: int = 128):
    """The linked forward/transpose v1 pair of ``g``'s real edges."""
    e = g.n_edges
    s, r = g.senders[:e].numpy(), g.receivers[:e].numpy()
    tiled, f_dst = _build_tiled_csr(s, r, g.indptr.numpy(), g.n_nodes,
                                    tile_rows=tile_rows)
    tiled_t, t_dst = _build_tiled_csr(
        g.t_senders[:e].numpy(), g.t_receivers[:e].numpy(),
        g.t_indptr.numpy(), g.n_nodes, tile_rows=tile_rows)
    # s is receiver-sorted; its stable argsort is the sender sort that
    # built the transpose arrays
    t_order = np.argsort(s, kind="stable")
    return _link_tiled_pair(tiled, f_dst, tiled_t, t_dst, t_order, e)


def pad_tiled_csr(t: TiledCSR, e_to: int, max_chunks_to: int) -> TiledCSR:
    """Pad a layout to a bucketed slot count and ``max_chunks``
    (``gist_tpu/graph.py:122``).  Padding slots carry the sentinel
    receiver and lie past ``tile_offsets[-1]``."""
    s, r = t.senders.numpy(), t.receivers.numpy()
    e_to = max(_round_up(e_to, t.chunk), len(s))
    extra = e_to - len(s)
    pio = None if t.pos_in_other is None else t.pos_in_other.numpy()
    if extra:
        s = np.concatenate([s, np.zeros(extra, np.int32)])
        r = np.concatenate([r, np.full(extra, t.num_tiles * t.tile_rows,
                                       np.int32)])
        if pio is not None:
            pio = np.concatenate([pio, np.zeros(extra, np.int32)])
    return dataclasses.replace(
        t, senders=torch.from_numpy(s), receivers=torch.from_numpy(r),
        pos_in_other=None if pio is None else torch.from_numpy(pio),
        max_chunks=max(t.max_chunks, max_chunks_to))


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


@dataclass(frozen=True)
class ChunkedDedupTiles:
    """The dedup layout cut into chunks of ``tiles_per_chunk`` tiles,
    each padded to one job count, so that a runner aggregates chunk by
    chunk with W and the features resident (``gist_tpu/graph.py:196``).
    ``u_senders`` and ``dir_blk`` index rows of the *permuted* features
    ``x[perm]``; output rows come in kernel order and ``pos`` takes them
    to node order.

    Split layout: when ``is_dir`` is set, a job with ``is_dir == 1``
    reads the CU-row block ``x[perm][dir_blk * CU : +CU]`` straight from
    the features (a *direct* job); any other reads the CU *remote* slots
    ``u_senders[c, rem_blk * CU : +CU]``, which then hold only the
    remote slots ((n_chunks, rem_pad * CU))."""

    u_senders: torch.Tensor    # (n_chunks, jobs_pad * CU) or (.., rem_pad*CU)
    w_blocks: torch.Tensor     # (n_chunks, jobs_pad, TN, CU) int8
    job_offsets: torch.Tensor  # (n_chunks, tiles_per_chunk + 1) int32
    pos: Optional[torch.Tensor]   # (N,) int32 node -> output row
    perm: Optional[torch.Tensor]  # (N,) int32 output row -> node
    dir_blk: Optional[torch.Tensor] = None  # (n_chunks, jobs_pad) int32
    rem_blk: Optional[torch.Tensor] = None  # (n_chunks, jobs_pad) int32
    is_dir: Optional[torch.Tensor] = None   # (n_chunks, jobs_pad) int32
    tile_rows: int = 64
    cu: int = 1024
    max_jobs: int = 0          # per tile
    num_tiles: int = 0

    @property
    def n_chunks(self) -> int:
        return self.w_blocks.shape[0]

    @property
    def tiles_per_chunk(self) -> int:
        return self.job_offsets.shape[1] - 1

    def to(self, device) -> "ChunkedDedupTiles":
        return dataclasses.replace(self, **{
            f: None if getattr(self, f) is None else getattr(self, f).to(
                device)
            for f in ("u_senders", "w_blocks", "job_offsets", "pos", "perm",
                      "dir_blk", "rem_blk", "is_dir")})


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
                     reorder: bool, seed: int, permute_u: bool = False):
    """Host-side build of the dedup layout: per destination tile, the
    padded unique-sender list and int8 count blocks, from one global
    sort over (tile, sender) pairs.  Returns (u_flat, w_flat,
    job_offsets, pos, perm) or None when there is no edge or an int8
    count would overflow (extreme multigraph).  ``permute_u`` emits the
    unique senders in the locality-permuted space (``perm`` set), as
    the chunked layout keeps them; W indices are int64 throughout (the
    flat scan of a Reddit-scale graph indexes ~3e9 W slots)."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    pos = perm = None
    if reorder and n_nodes > 2 * tile_rows:
        order_perm, pos = _locality_order(senders, receivers, n_nodes,
                                          tile_rows, seed=seed)
        r = pos[receivers]
        if permute_u:
            perm = order_perm
            senders = pos[senders]
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
    return u_flat, w_flat, job_offsets, pos, perm


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
    u_flat, w_flat, job_offsets, pos, _ = scan
    if w_flat.nbytes > max_w_bytes:
        return None
    return DedupTiles(
        u_senders=torch.from_numpy(u_flat),
        w_blocks=torch.from_numpy(w_flat),
        job_offsets=torch.from_numpy(job_offsets.astype(np.int32)),
        pos=None if pos is None else torch.from_numpy(pos.astype(np.int32)),
        tile_rows=tile_rows, cu=cu,
        max_jobs=int(np.diff(job_offsets).max()))


def _build_dedup_chunked(senders: np.ndarray, receivers: np.ndarray,
                         n_nodes: int, *, tile_rows: int = 128,
                         cu: int = 1024, reorder: bool = True, seed: int = 0,
                         chunk_rows: int = CHUNK_ROWS,
                         ) -> Optional[ChunkedDedupTiles]:
    """Chunked layout (``gist_tpu/graph.py:371``): the flat scan's tiles
    grouped into uniform chunks of ~``chunk_rows`` unique-row slots, all
    padded to one job count.  A chunk's padding tiles repeat its last
    job offset, so they have no jobs."""
    scan = _dedup_tile_scan(senders, receivers, n_nodes, tile_rows, cu,
                            reorder, seed, permute_u=True)
    if scan is None:
        return None
    u_flat, w_flat, job_offsets, pos, perm = scan
    num_tiles = len(job_offsets) - 1
    jobs_per_tile = np.diff(job_offsets)
    target_jobs = max(1, chunk_rows // cu)
    mean_jobs = max(float(jobs_per_tile.mean()), 1e-9)
    tpc = max(1, min(num_tiles, int(target_jobs / mean_jobs)))
    n_chunks = -(-num_tiles // tpc)
    chunk_lo = job_offsets[np.minimum(np.arange(n_chunks) * tpc, num_tiles)]
    chunk_hi = job_offsets[np.minimum((np.arange(n_chunks) + 1) * tpc,
                                      num_tiles)]
    jobs_pad = int((chunk_hi - chunk_lo).max())
    if jobs_pad == 0:
        return None

    w_out = np.zeros((n_chunks, jobs_pad, tile_rows, cu), dtype=np.int8)
    u_out = np.zeros((n_chunks, jobs_pad * cu), dtype=np.int32)
    offs_out = np.zeros((n_chunks, tpc + 1), dtype=np.int64)
    for c in range(n_chunks):
        lo, hi = int(chunk_lo[c]), int(chunk_hi[c])
        w_out[c, :hi - lo] = w_flat[lo:hi]
        u_out[c, :(hi - lo) * cu] = u_flat[lo * cu:hi * cu]
        t0, t1 = c * tpc, min((c + 1) * tpc, num_tiles)
        offs_out[c, :t1 - t0 + 1] = job_offsets[t0:t1 + 1] - lo
        offs_out[c, t1 - t0 + 1:] = offs_out[c, t1 - t0]  # padding tiles
    del w_flat
    return ChunkedDedupTiles(
        u_senders=torch.from_numpy(u_out),
        w_blocks=torch.from_numpy(w_out),
        job_offsets=torch.from_numpy(offs_out.astype(np.int32)),
        pos=None if pos is None else torch.from_numpy(pos.astype(np.int32)),
        perm=None if perm is None else torch.from_numpy(
            perm.astype(np.int32)),
        tile_rows=tile_rows, cu=cu,
        max_jobs=int(jobs_per_tile.max()), num_tiles=num_tiles)


def _ffill(values: np.ndarray, has_value: np.ndarray,
           fill0: int = 0) -> np.ndarray:
    """Carry each marked value forward over unmarked positions (leading
    unmarked positions get ``fill0``)."""
    idx = np.where(has_value, np.arange(len(values)), -1)
    np.maximum.accumulate(idx, out=idx)
    return np.where(idx >= 0, values[np.maximum(idx, 0)], fill0)


def _build_dedup_split_chunked(senders: np.ndarray, receivers: np.ndarray,
                               n_nodes: int, *, tile_rows: int = 64,
                               cu: int = 1024, threshold: int = 128,
                               chunk_rows: int = CHUNK_ROWS, seed: int = 0,
                               ) -> Optional[ChunkedDedupTiles]:
    """Chunked layout with the direct/remote split
    (``gist_tpu/graph.py:431``): a (destination tile, CU-row source
    block) pair with ``>= threshold`` edges becomes a direct job, whose
    W block pairs with that source block of the permuted features; the
    sparse remainder keeps unique remote slots.  Per tile, direct jobs
    come first, then remote jobs.  Chunks hold uniform tile counts sized
    by their remote rows.  The padding positions of ``dir_blk`` and
    ``rem_blk`` carry the previous value forward, as the JAX package's
    arrays do (the TPU pipeline skips refetches with them); the kernel reads
    ``dir_blk`` only for direct jobs and ``rem_blk`` only for remote
    ones."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    if len(senders) == 0:
        return None
    TN, CU = tile_rows, cu
    order_perm, pos = _locality_order(senders, receivers, n_nodes, TN,
                                      seed=seed)
    s_p = pos[senders]
    r_p = pos[receivers]
    num_tiles = -(-n_nodes // TN)
    n_blocks = -(-n_nodes // CU)
    tile_of = r_p // TN
    local_row = r_p - tile_of * TN
    blk_of = s_p // CU
    within_blk = s_p - blk_of * CU

    # dense/sparse split over (tile, source-block) pairs
    pk, p_inv, p_cnt = np.unique(tile_of * n_blocks + blk_of,
                                 return_inverse=True, return_counts=True)
    dense_pair = p_cnt >= threshold
    edge_dense = dense_pair[p_inv]

    # direct jobs: one per dense pair, tile-major (pk is sorted)
    d_tile = (pk[dense_pair] // n_blocks).astype(np.int64)
    d_blk = (pk[dense_pair] % n_blocks).astype(np.int64)
    dir_per_tile = np.bincount(d_tile, minlength=num_tiles)
    d_rank = np.arange(len(d_tile)) - np.searchsorted(d_tile, d_tile)

    # remote slots: unique (tile, sender) over the sparse edges
    sp_mask = ~edge_dense
    uk, inv2 = np.unique(tile_of[sp_mask] * n_nodes + s_p[sp_mask],
                         return_inverse=True)
    u_tile = (uk // n_nodes).astype(np.int64)
    u_node = (uk % n_nodes).astype(np.int64)
    u_cnt = np.bincount(u_tile, minlength=num_tiles)
    rem_per_tile = -(-u_cnt // CU)
    u_start = np.zeros(num_tiles + 1, dtype=np.int64)
    np.cumsum(u_cnt, out=u_start[1:])
    pos_in_tile = np.arange(len(uk), dtype=np.int64) - u_start[u_tile]

    jobs_per_tile = dir_per_tile + rem_per_tile
    job_offsets = np.zeros(num_tiles + 1, dtype=np.int64)
    np.cumsum(jobs_per_tile, out=job_offsets[1:])
    if int(job_offsets[-1]) == 0:
        return None
    max_jobs = int(jobs_per_tile.max())
    dir_job = job_offsets[d_tile] + d_rank
    rem_job_of_slot = (job_offsets[u_tile] + dir_per_tile[u_tile]
                       + pos_in_tile // CU)

    # chunking: uniform tiles per chunk, by remote-row budget
    target_rem = max(1, chunk_rows // CU)
    mean_rem = max(float(rem_per_tile.mean()), 1e-9)
    tpc = max(1, min(num_tiles, int(target_rem / mean_rem)))
    n_chunks = -(-num_tiles // tpc)
    t_lo = np.minimum(np.arange(n_chunks) * tpc, num_tiles)
    t_hi = np.minimum((np.arange(n_chunks) + 1) * tpc, num_tiles)
    chunk_job_lo = job_offsets[t_lo]
    jobs_pad = int((job_offsets[t_hi] - chunk_job_lo).max())
    if jobs_pad == 0:
        return None
    rem_offsets = np.zeros(num_tiles + 1, dtype=np.int64)
    np.cumsum(rem_per_tile, out=rem_offsets[1:])
    chunk_rem_lo = rem_offsets[t_lo]
    rem_pad = max(int((rem_offsets[t_hi] - chunk_rem_lo).max()), 1)
    chunk_of_tile = np.minimum(np.arange(num_tiles) // tpc, n_chunks - 1)

    def padded_job(job_ids, tiles):
        c = chunk_of_tile[tiles]
        return c * jobs_pad + (job_ids - chunk_job_lo[c])

    pj_dir = padded_job(dir_job, d_tile)                # per dense pair
    pj_rem_slot = padded_job(rem_job_of_slot, u_tile)   # per remote slot

    # W blocks, scattered straight into the padded layout (int64 index)
    w_out = np.zeros((n_chunks * jobs_pad, TN, CU), dtype=np.int8)
    w_idx_parts = []
    if edge_dense.any():
        pair_to_pj = np.full(len(pk), -1, dtype=np.int64)
        pair_to_pj[np.nonzero(dense_pair)[0]] = pj_dir
        w_idx_parts.append(
            (pair_to_pj[p_inv[edge_dense]] * TN
             + local_row[edge_dense]) * CU + within_blk[edge_dense])
    if sp_mask.any():
        w_idx_parts.append(
            (pj_rem_slot[inv2].astype(np.int64) * TN
             + local_row[sp_mask]) * CU + pos_in_tile[inv2] % CU)
    w_idx = np.concatenate(w_idx_parts) if w_idx_parts else \
        np.zeros(0, np.int64)
    w_idx.sort(kind="stable")
    boundary = np.empty(len(w_idx), dtype=bool)
    if len(w_idx):
        boundary[0] = True
        np.not_equal(w_idx[1:], w_idx[:-1], out=boundary[1:])
    starts = np.nonzero(boundary)[0]
    cnts = np.diff(np.append(starts, len(w_idx)))
    if cnts.max(initial=0) > 127:
        return None  # int8 count overflow
    w_out.reshape(-1)[w_idx[starts]] = cnts.astype(np.int8)
    w_out = w_out.reshape(n_chunks, jobs_pad, TN, CU)

    # remote ids, packed per chunk: remote-job rank within the chunk
    c_of_slot = chunk_of_tile[u_tile]
    rem_rank = (rem_job_of_slot
                - (job_offsets[u_tile] + dir_per_tile[u_tile])
                + rem_offsets[u_tile] - chunk_rem_lo[c_of_slot])
    u_out = np.zeros((n_chunks, rem_pad * CU), dtype=np.int32)
    u_out.reshape(-1)[c_of_slot * (rem_pad * CU) + rem_rank * CU
                      + pos_in_tile % CU] = u_node

    # per-job arrays
    is_dir = np.zeros(n_chunks * jobs_pad, dtype=np.int32)
    is_dir[pj_dir] = 1
    dblk_vals = np.zeros(n_chunks * jobs_pad, dtype=np.int64)
    dblk_vals[pj_dir] = d_blk
    dir_blk = _ffill(dblk_vals, is_dir.astype(bool)).astype(np.int32)
    rem_jobs_pj = np.unique(pj_rem_slot) if sp_mask.any() else \
        np.zeros(0, np.int64)
    rblk_vals = np.zeros(n_chunks * jobs_pad, dtype=np.int64)
    has_rem = np.zeros(n_chunks * jobs_pad, dtype=bool)
    if len(rem_jobs_pj):
        order = np.argsort(pj_rem_slot, kind="stable")
        firsts = order[np.searchsorted(pj_rem_slot[order], rem_jobs_pj)]
        rblk_vals[rem_jobs_pj] = rem_rank[firsts]
        has_rem[rem_jobs_pj] = True
    rem_blk = np.minimum(_ffill(rblk_vals, has_rem).astype(np.int32),
                         rem_pad - 1)

    offs_out = np.zeros((n_chunks, tpc + 1), dtype=np.int64)
    for c in range(n_chunks):
        a, b = int(t_lo[c]), int(t_hi[c])
        offs_out[c, :b - a + 1] = job_offsets[a:b + 1] - chunk_job_lo[c]
        offs_out[c, b - a + 1:] = offs_out[c, b - a]

    def conv(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
    return ChunkedDedupTiles(
        u_senders=torch.from_numpy(u_out), w_blocks=torch.from_numpy(w_out),
        job_offsets=conv(offs_out), pos=conv(pos), perm=conv(order_perm),
        dir_blk=conv(dir_blk.reshape(n_chunks, jobs_pad)),
        rem_blk=conv(rem_blk.reshape(n_chunks, jobs_pad)),
        is_dir=conv(is_dir.reshape(n_chunks, jobs_pad)),
        tile_rows=TN, cu=CU, max_jobs=max_jobs, num_tiles=num_tiles)


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
    tiled: Optional[TiledCSR] = None      # v1 gather layout, forward
    tiled_t: Optional[TiledCSR] = None    # v1 gather layout, transpose
    dedup: Optional[DedupTiles] = None    # forward dedup layout
    dedup_t: Optional[DedupTiles] = None  # transpose layout (backward)
    # chunked or split layouts, for graphs too large for the flat one
    dedup_c: Optional[ChunkedDedupTiles] = None
    dedup_c_t: Optional[ChunkedDedupTiles] = None

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
            tiled=self.tiled_t, tiled_t=self.tiled,
            dedup=self.dedup_t, dedup_t=self.dedup,
            dedup_c=self.dedup_c_t, dedup_c_t=self.dedup_c)

    def to(self, device) -> "Graph":
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self)}
        for k, v in fields.items():
            if isinstance(v, (torch.Tensor, TiledCSR, DedupTiles,
                              ChunkedDedupTiles)):
                fields[k] = v.to(device)
        return Graph(**fields)

    @property
    def n_edges_padded(self) -> int:
        return self.senders.shape[0]

    def with_tiles(self, tile_rows: int = 128, mode: str = "dedup",
                   chunk_rows: Optional[int] = None,
                   transpose: bool = True) -> "Graph":
        """Return a copy carrying tile layouts, rebuilt on the host from
        the edge arrays; a no-op if present (``gist_tpu/graph.py:667``).

        ``mode="dedup"`` builds the flat layout pair, or the chunked
        pair above ``HUGE_EDGES`` edges; ``mode="dedup-chunked"`` forces
        the chunked pair; ``mode="gather"`` builds the linked v1 pair
        (``tiled``, ``tiled_t``).  A failed dedup build (W too large, an
        int8 count overflow) falls through to the v1 pair, as in the JAX
        package, so a graph may carry a dedup layout and the v1 one.
        ``chunk_rows`` (default ``CHUNK_ROWS``) bounds one chunk's
        unique-row slots.  ``transpose=False`` skips the chunked
        transpose layout, for forward-only consumers."""
        if mode not in ("dedup", "dedup-chunked", "gather"):
            raise ValueError(f"unknown tile mode {mode!r}")
        chunk_rows = CHUNK_ROWS if chunk_rows is None else chunk_rows
        e = self.n_edges
        s, r = self.senders[:e].numpy(), self.receivers[:e].numpy()
        t_s, t_r = self.t_senders[:e].numpy(), self.t_receivers[:e].numpy()
        huge = e > HUGE_EDGES
        if mode == "dedup-chunked" or (mode == "dedup" and huge):
            if self.dedup_c is not None or self.dedup is not None:
                return self
            d = _build_dedup_chunked(s, r, self.n_nodes, tile_rows=tile_rows,
                                     chunk_rows=chunk_rows)
            if d is not None and not transpose:
                return self.replace(dedup_c=d)
            d_t = None if d is None else _build_dedup_chunked(
                t_s, t_r, self.n_nodes, tile_rows=tile_rows,
                chunk_rows=chunk_rows)
            if d is not None and d_t is not None:
                return self.replace(dedup_c=d, dedup_c_t=d_t)
            mode = "dedup" if mode == "dedup" and not huge else "gather"
        if mode == "dedup":
            if self.dedup is not None:
                return self
            d = _build_dedup_tiles(s, r, self.n_nodes, tile_rows=tile_rows)
            d_t = None if d is None else _build_dedup_tiles(
                t_s, t_r, self.n_nodes, tile_rows=tile_rows)
            if d is not None and d_t is not None:
                return self.replace(dedup=d, dedup_t=d_t)
        if self.tiled is not None:
            return self
        tiled, tiled_t = _build_tiled_pair(self, tile_rows)
        return self.replace(tiled=tiled, tiled_t=tiled_t)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Graph(n_nodes={self.n_nodes}, n_edges={self.n_edges}, "
                f"padded={self.n_edges_padded})")


def graph_from_edges(senders, receivers, n_nodes: int, *,
                     pad_to: Optional[int] = None,
                     tiles: bool = False, tile_rows: int = 128,
                     tile_mode: str = "dedup") -> Graph:
    """Build a receiver-sorted padded Graph (CPU tensors) from a raw COO
    edge list; host-side numpy preprocessing.  ``tiles=True`` adds the
    layouts of ``with_tiles(tile_rows, mode=tile_mode)``."""
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
        g = g.with_tiles(tile_rows=tile_rows, mode=tile_mode)
    return g


def add_self_loops(senders, receivers, n_nodes: int, *, dedup: bool = True):
    """Drop existing self loops (``dedup``) and append one per node
    (``gist_tpu/graph.py:808``)."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    if dedup:
        keep = senders != receivers
        senders, receivers = senders[keep], receivers[keep]
    loop = np.arange(n_nodes, dtype=np.int64)
    return np.concatenate([senders, loop]), np.concatenate([receivers, loop])


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


def sym_norm(graph: Graph) -> torch.Tensor:
    """Symmetric GCN norm ``deg^{-1/2}`` over in-degrees, 0 where the
    degree is 0 (``gist_tpu/graph.py:841``)."""
    deg = graph.in_degrees
    return torch.where(deg > 0, torch.rsqrt(deg.clamp(min=1.0)), 0.0)


def inv_degree_norm(graph: Graph) -> torch.Tensor:
    """Mean-aggregation norm ``1/deg`` over in-degrees, 0 where the
    degree is 0 (``gist_tpu/graph.py:849``)."""
    deg = graph.in_degrees
    return torch.where(deg > 0, 1.0 / deg.clamp(min=1.0), 0.0)
