"""S1: the CSR row-walk segment sum as a hand-written CUDA kernel, with its
plain PyTorch version and the autograd Functions of the segment path.

S1 replaces no TPU kernel: it is the card's counterpart of XLA's
``segment_sum`` in the JAX package's segment path
(``gist_tpu/ops/spmm.py:84``, ``gist_tpu/ops/segment.py:64`` and
``:86``).  :func:`segment_csr` computes, for each output row i and head h,

    out[i, h] = sum_{e = indptr[i]}^{indptr[i+1]-1} w[e, h] * v[idx[e], h]

(``idx`` the identity and ``w`` 1 where they are None), in edge order,
with fp32 accumulation and v's dtype out.  The kernel source is
``gist_tpu_torch/csrc/segment_csr.cu``; it is compiled by ``nvcc`` for
``sm_90a`` into ``gist_tpu_torch/_build/`` at first use and loaded with
ctypes, as K1 is.  It launches for a CUDA tensor and raises if it cannot;
:func:`segment_csr_reference` (a gather and ``index_add_``, the plain
version) runs for a CPU tensor.  ``launches`` counts the kernel launches.

The Functions wire every sum of the segment path and every backward of
one of its gathers through :func:`segment_csr`, so no step sums with
atomics on the card and the result does not depend on the schedule:

* :func:`aggregate`, ``out = A x`` over ``(indptr, senders)``; its
  backward ``dx = A^T g`` over the transpose view ``(t_indptr,
  t_senders)`` that every Graph carries;
* :func:`sum_rows`, per-edge rows summed into their receivers; its
  backward gathers by receiver;
* :func:`gather`, a row gather whose backward is a CSR sum over the
  index's own CSR: the receivers' (``indptr``), the senders' (``t_indptr``
  through ``Graph.t_perm``, the edges in sender order), or one sorted on
  the device (:func:`index_csr`);
* :func:`weighted_sum`, ``h_r = sum_e alpha_e z_{s_e}``; its backward
  runs ``dz`` over the transpose view with alpha permuted to sender order
  and ``dalpha_e = <z[s_e], g[r_e]>`` per edge.

Padding edges (receiver ``n_nodes``) lie past ``indptr[-1]`` and
``t_indptr[-1]``: no sum reads them, and they take no gradient (the
segment path masks their weights to 0 before any use).  On the CPU the
same Functions run the plain versions, one chunk of ~1 GiB of messages at
a time.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import NamedTuple, Optional

import torch

from gist_tpu_torch.ops import dedup_spmm

SOURCE = os.path.join(os.path.dirname(dedup_spmm.SOURCE), "segment_csr.cu")

launches = 0
_lib = None

# the kernel's instances (csrc/segment_csr.cu): lanes per group, and the
# accumulators a lane holds (per_lane * vec); its C entry by dtype
GROUPS = (4, 8, 16, 32)
COLS = 8
_ENTRIES = {torch.float32: "f32", torch.bfloat16: "bf16",
            torch.float64: "f64"}


class Plan(NamedTuple):
    """An S1 launch plan: each (row, head) segment owned by ``group``
    lanes, each lane loading ``vec`` elements at a time, so a group covers
    ``span`` columns of one block column."""
    group: int
    vec: int

    @property
    def span(self) -> int:
        return self.group * COLS

    def grid(self, n_rows: int, heads: int, f: int) -> tuple:
        """(blocks over the segments, block columns) of a launch; a block
        holds 256 lanes (``tiled_rows::THREADS``)."""
        per_block = 256 // self.group
        return (-(-(n_rows * heads) // per_block), -(-f // self.span))


def vec_width(f: int, item: int, *ptrs: int) -> int:
    """The widest vector of at most 16 bytes, in {8, 4, 2, 1} elements,
    that divides ``f`` and to which every address in ``ptrs`` is
    aligned (elements of ``item`` bytes)."""
    for v in (8, 4, 2):
        if v * item <= 16 and f % v == 0 and all(
                p % (v * item) == 0 for p in ptrs):
            return v
    return 1


def launch_plan(f: int, vec: int) -> Plan:
    """The plan S1 launches at row width ``f``: the smallest group whose
    ``COLS`` columns a lane cover the row in one block column, 32 lanes
    (and several block columns) past 256 columns."""
    group = next((g for g in GROUPS if g * COLS >= f), GROUPS[-1])
    return Plan(group, vec)


def _load():
    global _lib
    if _lib is None:
        sig = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        _lib = dedup_spmm.load_library(SOURCE, {f"segment_csr_{k}": sig
                                                for k in _ENTRIES.values()})
    return _lib


def _out_dtype(v: torch.Tensor, w: Optional[torch.Tensor]) -> torch.dtype:
    return v.dtype if w is None else torch.promote_types(v.dtype, w.dtype)


def _edge_chunk(v: torch.Tensor, edge_chunk: Optional[int]) -> int:
    """Edges of ~1 GiB of gathered messages a chunk, unless given."""
    if edge_chunk is not None:
        return max(int(edge_chunk), 1)
    row_bytes = max(v[0].numel() * 4, 1) if v.shape[0] else 4
    return max(2 ** 30 // row_bytes, 65536)


def _expand(w: torch.Tensor, ndim: int) -> torch.Tensor:
    return w.reshape(tuple(w.shape) + (1,) * (ndim - w.dim()))


def segment_csr_reference(indptr: torch.Tensor, v: torch.Tensor,
                          idx: Optional[torch.Tensor] = None,
                          w: Optional[torch.Tensor] = None,
                          edge_chunk: Optional[int] = None) -> torch.Tensor:
    """Plain version: each edge's row ``w[e] * v[idx[e]]`` (``v[e]``
    without ``idx``) gathered and added into its row by ``index_add_``,
    the edges in chunks of ~1 GiB of messages; accumulated in fp32 (or
    float64 for float64 inputs), cast to the inputs' promoted dtype.  On
    the CPU ``index_add_`` adds in edge order; on the card with
    atomics."""
    n = indptr.shape[0] - 1
    dt = _out_dtype(v, w)
    acc = torch.promote_types(dt, torch.float32)
    out = torch.zeros((n,) + tuple(v.shape[1:]), dtype=acc, device=v.device)
    first, last = int(indptr[0]), int(indptr[-1])
    if n <= 0 or last <= first:
        return out.to(dt)
    counts = (indptr[1:] - indptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(n, device=v.device), counts,
                                   output_size=last - first)
    chunk = _edge_chunk(v, edge_chunk)
    for a in range(first, last, chunk):
        b = min(a + chunk, last)
        m = v[a:b] if idx is None else v.index_select(0, idx[a:b].long())
        m = m.to(acc)
        if w is not None:
            m = m * _expand(w[a:b].to(acc), m.dim())
        out.index_add_(0, rows[a - first:b - first], m)
    return out.to(dt)


def _check(indptr, v, idx, w, heads):
    if v.dtype not in _ENTRIES:
        raise TypeError(f"segment_csr takes float32, bfloat16 or float64, "
                        f"not {v.dtype}")
    if indptr.dtype != torch.int32 or (idx is not None
                                       and idx.dtype != torch.int32):
        raise TypeError("indptr and idx must be int32")
    if w is not None and (w.dim() > 2 or w.numel() != w.shape[0] * heads):
        raise ValueError(f"w must be (E,) or (E, heads), got "
                         f"{tuple(w.shape)} for {heads} heads")
    for t in (indptr, v, idx, w):
        if t is not None and t.device != v.device:
            raise ValueError("indptr, idx, w and v must be on one device")
    if v.device.index != torch.cuda.current_device():
        raise ValueError(f"v is on {v.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def segment_csr(indptr: torch.Tensor, v: torch.Tensor,
                idx: Optional[torch.Tensor] = None,
                w: Optional[torch.Tensor] = None,
                edge_chunk: Optional[int] = None) -> torch.Tensor:
    """``out[i] = sum_{e in [indptr[i], indptr[i+1])} w[e] * v[idx[e]]``
    in edge order: ``indptr`` (n + 1,) int32, ``idx`` (E,) int32 rows of
    v or None (edge e reads ``v[e]``), ``w`` (E,) or (E, H) or None, ``v``
    (rows, ...) or, with a (E, H) ``w``, (rows, H, ...).  Returns
    (n, *v.shape[1:]) in the promoted dtype of v and w.

    CUDA tensors launch S1 (or raise); CPU tensors take the plain version
    (``edge_chunk`` bounds its messages); no other device is accepted."""
    global launches
    if v.device.type == "cpu":
        return segment_csr_reference(indptr, v, idx, w, edge_chunk)
    if v.device.type != "cuda":
        raise ValueError(f"segment_csr runs on cuda or cpu, not {v.device}")
    dt = _out_dtype(v, w)
    v = v.to(dt).contiguous()
    n = indptr.shape[0] - 1
    rest = tuple(v.shape[1:])
    heads = 1 if w is None or w.dim() == 1 else w.shape[1]
    if heads > 1 and (not rest or rest[0] != heads):
        raise ValueError(f"v {tuple(v.shape)} does not hold w's {heads} "
                         f"heads")
    f = math.prod(rest[1:] if heads > 1 else rest)
    _check(indptr, v, idx, w, heads)
    w = None if w is None else w.to(
        torch.promote_types(dt, torch.float32)).contiguous()
    indptr = indptr.contiguous()
    idx = None if idx is None else idx.contiguous()
    out = torch.empty((n,) + rest, dtype=dt, device=v.device)
    plan = launch_plan(f, vec_width(f, v.element_size(), v.data_ptr(),
                                    out.data_ptr()))
    lib = _load()
    fn = getattr(lib, f"segment_csr_{_ENTRIES[dt]}")
    err = fn(indptr.data_ptr(), 0 if idx is None else idx.data_ptr(),
             0 if w is None else w.data_ptr(), v.data_ptr(), out.data_ptr(),
             n, heads, f, plan.group, plan.vec,
             torch.cuda.current_stream(v.device).cuda_stream)
    if err:
        raise RuntimeError(f"segment_csr launch failed: CUDA error {err}")
    launches += 1
    return out


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with zero rows appended up to ``rows``."""
    if t.shape[0] >= rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],)
                                     + tuple(t.shape[1:]))])


def index_csr(idx: torch.Tensor, n: int) -> tuple:
    """(indptr, perm) of an index into n rows, on its device: ``perm``
    the positions of ``idx`` stably sorted by value (int32) and
    ``indptr`` (n + 1,) int32 the range of each value in that order;
    values outside [0, n) fall past ``indptr[-1]``."""
    key = torch.where((idx >= 0) & (idx < n), idx.long(), n)
    srt, perm = torch.sort(key, stable=True)
    bounds = torch.arange(n + 1, device=idx.device)
    indptr = torch.searchsorted(srt, bounds, out_int32=True)
    return indptr, perm.to(torch.int32)


def sender_perm(graph) -> torch.Tensor:
    """The graph's edges in sender order (``Graph.t_perm``), sorted
    stably on its device where the graph does not carry them."""
    if graph.t_perm is not None:
        return graph.t_perm
    key = torch.where(graph.receivers < graph.n_nodes, graph.senders,
                      graph.n_nodes)
    return index_csr(key, graph.n_nodes)[1]


class _Aggregate(torch.autograd.Function):
    """``out = A x`` over ``(indptr, idx)``; ``dx = A^T g`` over the
    transpose ``(t_indptr, t_idx)``."""

    @staticmethod
    def forward(ctx, x, indptr, idx, t_indptr, t_idx, edge_chunk):
        ctx.t, ctx.rows, ctx.edge_chunk = (t_indptr, t_idx), x.shape[0], \
            edge_chunk
        return segment_csr(indptr, x, idx, edge_chunk=edge_chunk)

    @staticmethod
    def backward(ctx, g):
        t_indptr, t_idx = ctx.t
        dx = segment_csr(t_indptr, g.contiguous(), t_idx,
                         edge_chunk=ctx.edge_chunk)
        return _pad_rows(dx, ctx.rows), None, None, None, None, None


def aggregate(graph, x: torch.Tensor,
              edge_chunk: Optional[int] = None) -> torch.Tensor:
    """``out[i] = sum_{(s, i) in E} x[s]``: the segment path's SpMM,
    differentiable in x through the transpose view."""
    return _Aggregate.apply(x, graph.indptr, graph.senders, graph.t_indptr,
                            graph.t_senders, edge_chunk)


class _SumRows(torch.autograd.Function):
    """Per-edge rows summed into their receivers; the backward gathers
    by receiver (padding edges, receiver n, get 0)."""

    @staticmethod
    def forward(ctx, m, indptr, receivers):
        ctx.receivers, ctx.n = receivers, indptr.shape[0] - 1
        return segment_csr(indptr, m)

    @staticmethod
    def backward(ctx, g):
        n = ctx.n
        g_pad = torch.cat([g, g.new_zeros((1,) + tuple(g.shape[1:]))])
        return g_pad.index_select(0, ctx.receivers.long().clamp(max=n)), \
            None, None


def sum_rows(m: torch.Tensor, indptr: torch.Tensor,
             receivers: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum m[e]`` over row i's edges, ``receivers`` (E,) the
    row of each edge (sorted; padding n), ``indptr`` its CSR."""
    return _SumRows.apply(m, indptr, receivers)


class _Gather(torch.autograd.Function):
    """``y[idx]`` (idx clipped to y's rows); the backward sums each row's
    cotangents over the index's CSR ``(indptr, perm)``: ``perm`` the
    positions of idx in row order (None: idx is sorted)."""

    @staticmethod
    def forward(ctx, y, idx, indptr, perm):
        ctx.csr, ctx.rows = (indptr, perm), y.shape[0]
        return y.index_select(0, idx.long().clamp(max=y.shape[0] - 1))

    @staticmethod
    def backward(ctx, g):
        indptr, perm = ctx.csr
        dy = segment_csr(indptr, g.contiguous(), perm)
        return _pad_rows(dy, ctx.rows), None, None, None


def gather(y: torch.Tensor, idx: torch.Tensor,
           indptr: Optional[torch.Tensor] = None,
           perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jnp.take(y, idx, axis=0, mode="clip")`` with a deterministic
    backward: ``indptr`` and ``perm`` are idx's CSR (:func:`index_csr`),
    sorted on the device when not given.  Entries of idx past y's rows
    read its last row and take no gradient."""
    if indptr is None:
        indptr, perm = index_csr(idx, y.shape[0])
    return _Gather.apply(y, idx, indptr, perm)


def gather_receivers(graph, y: torch.Tensor) -> torch.Tensor:
    """``y[receivers]`` (padding edges read row n - 1)."""
    return gather(y, graph.receivers, graph.indptr, None)


def gather_senders(graph, y: torch.Tensor) -> torch.Tensor:
    """``y[senders]``."""
    return gather(y, graph.senders, graph.t_indptr, sender_perm(graph))


class _WeightedSum(torch.autograd.Function):
    """``h_r = sum_e alpha_e z_{s_e}``: S1 with weights; the backward runs
    ``dz`` over the transpose view with alpha in sender order and
    ``dalpha_e = <z[s_e], g[r_e]>`` per real edge."""

    @staticmethod
    def forward(ctx, z, alpha, graph, perm, edge_chunk):
        ctx.save_for_backward(z, alpha)
        ctx.graph, ctx.perm, ctx.edge_chunk = graph, perm, edge_chunk
        return segment_csr(graph.indptr, z, graph.senders, alpha, edge_chunk)

    @staticmethod
    def backward(ctx, g):
        z, alpha = ctx.saved_tensors
        graph, perm, chunk = ctx.graph, ctx.perm, ctx.edge_chunk
        g = g.contiguous()
        dz = dalpha = None
        if ctx.needs_input_grad[0]:
            dz = segment_csr(graph.t_indptr, g, graph.t_senders,
                             alpha.index_select(0, perm.long()), chunk)
            dz = _pad_rows(dz, z.shape[0]).to(z.dtype)
        if ctx.needs_input_grad[1]:
            n = graph.n_nodes
            acc = torch.promote_types(g.dtype, torch.float32)
            dalpha = torch.zeros(alpha.shape, dtype=acc, device=g.device)
            e_pad = alpha.shape[0]
            step = _edge_chunk(z, chunk)
            for a in range(0, e_pad, step):
                r = graph.receivers[a:a + step].long()
                zs = z.index_select(0, graph.senders[a:a + step].long())
                gr = g.index_select(0, r.clamp(max=n - 1))
                d = (zs.to(acc) * gr.to(acc)).flatten(alpha.dim())
                d = d.sum(-1)
                dalpha[a:a + step] = torch.where(
                    _expand(r < n, d.dim()), d, 0.0)
            dalpha = dalpha.to(alpha.dtype)
        return dz, dalpha, None, None, None


def weighted_sum(graph, z: torch.Tensor, alpha: torch.Tensor,
                 edge_chunk: Optional[int] = None) -> torch.Tensor:
    """``h_r = sum_e alpha_e z_{send(e)}``: z (N, D) with alpha (E,), or
    z (N, H, D) with alpha (E, H); differentiable in both."""
    return _WeightedSum.apply(z, alpha, graph, sender_perm(graph),
                              edge_chunk)
