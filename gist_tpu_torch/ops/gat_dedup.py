"""K4, K5, K6: GAT attention over the dedup layout as hand-written CUDA
kernels, with their plain PyTorch versions and the fused backward.

Counterpart of the dedup half of ``gist_tpu/ops/pallas_gat.py``
(``_gat_dedup_kernel``, ``_gat_dedup_bwd_b1_kernel``,
``_gat_dedup_bwd_b2_kernel``, ``gat_attention_dedup(_mh)`` and
``_gat_dedup_backward_fused``).  The kernel source is
``gist_tpu_torch/csrc/gat_dedup.cu``; it is compiled by ``nvcc`` for
``sm_90a`` into ``gist_tpu_torch/_build/`` at first use and loaded with
ctypes through a plain C interface, as K1 is.

The three wrappers (:func:`gat_fwd`, :func:`gat_bwd_b1`,
:func:`gat_bwd_b2`) take per-row arrays in the layout's kernel row order
and per-node arrays in node order.  Each launches its kernel for CUDA
tensors (or raises) and runs its plain version (the same walk over tiles
and jobs) for CPU tensors; ``launches_fwd``, ``launches_b1`` and
``launches_b2`` count the launches.

:func:`gat_attention_dedup_mh` (all heads) and :func:`gat_attention_dedup`
(one head) are differentiable.  Their backward runs K5 and K6 once per
head (``set_gat_backward("fused")``, the default) or autograd through the
segment composite (``"xla"``, the exact reference).
:func:`gat_attention_dedup_chunked` runs K4 once per chunk of the
chunked layout (the full-graph attention of graphs too large for the
flat one); its backward is the segment composite, head by head.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from gist_tpu_torch.graph import ChunkedDedupTiles, DedupTiles, Graph
from gist_tpu_torch.ops import dedup_spmm
from gist_tpu_torch.ops.dedup_spmm import CU, TILE_ROWS

NEG_INF = -1e30

SOURCE = os.path.join(os.path.dirname(dedup_spmm.SOURCE), "gat_dedup.cu")

launches_fwd = 0
launches_b1 = 0
launches_b2 = 0
_lib = None


def reset_launches() -> None:
    global launches_fwd, launches_b1, launches_b2
    launches_fwd = launches_b1 = launches_b2 = 0


def _load():
    global _lib
    if _lib is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        sigs = {"gat_fwd": [p] * 9 + [i, i, i, f, p],
                "gat_bwd_b1": [p] * 11 + [i, i, f, p],
                "gat_bwd_b2": [p] * 12 + [i, i, f, p]}
        _lib = dedup_spmm.load_library(SOURCE, {
            f"{name}_{suffix}": args for name, args in sigs.items()
            for suffix in ("f32", "bf16")})
    return _lib


def _lrelu(x, slope):
    return torch.where(x > 0, x, slope * x)


# ---------------------------------------------------------------------------
# Plain versions: the kernels' walk over tiles and jobs in PyTorch
# ---------------------------------------------------------------------------


def gat_fwd_reference(job_offsets, w_blocks, u_senders, z, src, dst_rows,
                      negative_slope):
    """K4's plain version.  z (N, H, O); src (N, H) and dst_rows
    (tiles*TN, H) fp32 -> (out (tiles*TN, H, O) in z's dtype, m, l
    (tiles*TN, H) fp32), all in kernel row order."""
    num_tiles = job_offsets.shape[0] - 1
    tn, cu = w_blocks.shape[1], w_blocks.shape[2]
    heads, o = z.shape[1], z.shape[2]
    rows = num_tiles * tn
    dev = z.device
    zf = z.float()
    out = torch.zeros((rows, heads, o), dtype=torch.float32, device=dev)
    m = torch.full((rows, heads), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((rows, heads), dtype=torch.float32, device=dev)
    offs = job_offsets.tolist()
    for i in range(num_tiles):
        jobs = range(offs[i], offs[i + 1])
        if not jobs:
            continue
        d = dst_rows[i * tn:(i + 1) * tn]                       # (TN, H)
        blocks = []
        mx = torch.full((tn, heads), NEG_INF, dtype=torch.float32,
                        device=dev)
        for j in jobs:
            w = w_blocks[j].float()[:, :, None]                 # (TN, CU, 1)
            u = u_senders[j * cu:(j + 1) * cu].long()
            e = _lrelu(d[:, None, :] + src[u][None, :, :], negative_slope)
            e = torch.where(w > 0, e, NEG_INF)
            mx = torch.maximum(mx, e.amax(dim=1))
            blocks.append((w, u, e))
        s = torch.zeros((tn, heads), dtype=torch.float32, device=dev)
        acc = torch.zeros((tn, heads, o), dtype=torch.float32, device=dev)
        for w, u, e in blocks:
            p = w * torch.exp(torch.where(w > 0, e - mx[:, None, :],
                                          NEG_INF))
            s += p.sum(dim=1)
            acc += torch.einsum("rch,cho->rho", p, zf[u])
        sl = slice(i * tn, (i + 1) * tn)
        out[sl] = torch.where(s[:, :, None] > 0,
                              acc / s.clamp(min=1e-20)[:, :, None], 0.0)
        m[sl], l[sl] = mx, s
    return out.to(z.dtype), m, l


def _probabilities(w, raw, m, l, negative_slope):
    """A = w exp(min(e - m, 0)) / max(l, 1e-20) on w > 0, and lrelu'."""
    e = _lrelu(raw, negative_slope)
    a = torch.where(w > 0, w * torch.exp(torch.clamp(e - m, max=0.0))
                    / l.clamp(min=1e-20), 0.0)
    return a, torch.where(raw > 0, 1.0, negative_slope)


def gat_bwd_b1_reference(job_offsets, w_blocks, u_senders, g_rows, z,
                         dst_rows, src, m_rows, l_rows, c_rows,
                         negative_slope):
    """K5's plain version: ``ddst_r = sum_u A (G_r . z_u - c_r) lrelu'``
    over the forward layout; every per-row input in kernel row order."""
    num_tiles = job_offsets.shape[0] - 1
    tn, cu = w_blocks.shape[1], w_blocks.shape[2]
    ddst = torch.zeros(num_tiles * tn, dtype=torch.float32,
                       device=z.device)
    offs = job_offsets.tolist()
    for i in range(num_tiles):
        sl = slice(i * tn, (i + 1) * tn)
        for j in range(offs[i], offs[i + 1]):
            w = w_blocks[j].float()
            u = u_senders[j * cu:(j + 1) * cu].long()
            a, gp = _probabilities(w, dst_rows[sl, None] + src[u][None, :],
                                   m_rows[sl, None], l_rows[sl, None],
                                   negative_slope)
            dalpha = g_rows[sl] @ z[u].float().T
            ddst[sl] += (a * (dalpha - c_rows[sl, None]) * gp).sum(dim=1)
    return ddst


def gat_bwd_b2_reference(job_offsets, w_blocks, u_senders, z_rows, src_rows,
                         g, dst, m, l, c, negative_slope):
    """K6's plain version over the transpose layout (tile rows are
    senders s, slots receivers r): ``dz_s = sum_r A G_r`` (z's dtype) and
    ``dsrc_s = sum_r A (z_s . G_r - c_r) lrelu'`` (fp32)."""
    num_tiles = job_offsets.shape[0] - 1
    tn, cu = w_blocks.shape[1], w_blocks.shape[2]
    dev = z_rows.device
    dz = torch.zeros((num_tiles * tn, g.shape[1]), dtype=torch.float32,
                     device=dev)
    dsrc = torch.zeros(num_tiles * tn, dtype=torch.float32, device=dev)
    zf = z_rows.float()
    offs = job_offsets.tolist()
    for i in range(num_tiles):
        sl = slice(i * tn, (i + 1) * tn)
        for j in range(offs[i], offs[i + 1]):
            w = w_blocks[j].float()
            u = u_senders[j * cu:(j + 1) * cu].long()
            a, gp = _probabilities(w, src_rows[sl, None] + dst[u][None, :],
                                   m[u][None, :], l[u][None, :],
                                   negative_slope)
            gu = g[u]
            dz[sl] += a @ gu
            dalpha = zf[sl] @ gu.T
            dsrc[sl] += (a * (dalpha - c[u][None, :]) * gp).sum(dim=1)
    return dz.to(z_rows.dtype), dsrc


# ---------------------------------------------------------------------------
# Wrappers: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------


def _check_layout(name, job_offsets, w_blocks, u_senders, dev):
    if tuple(w_blocks.shape[1:]) != (TILE_ROWS, CU):
        raise ValueError(f"{name} needs TN={TILE_ROWS}, CU={CU} blocks, "
                         f"got {tuple(w_blocks.shape[1:])}")
    if (job_offsets.dtype, w_blocks.dtype, u_senders.dtype) != (
            torch.int32, torch.int8, torch.int32):
        raise TypeError("layout must be int32 offsets, int8 W, int32 senders")
    if u_senders.shape[0] != w_blocks.shape[0] * CU:
        raise ValueError("u_senders must hold CU slots per job")
    if w_blocks.data_ptr() % 16:
        raise ValueError("w_blocks must be 16-byte aligned")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors are on {dev}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _check(name, tensors, shapes, dev):
    """``shapes``: name -> (tensor, expected shape, allowed dtypes)."""
    for key, (t, shape, dtypes) in shapes.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, not {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {key} must be one of {dtypes}, not "
                            f"{t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: layout tensors must be contiguous "
                             f"and on {dev}")


_F32 = (torch.float32,)
_FEAT = (torch.float32, torch.bfloat16)


def _device(z, name):
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {z.device}")
    return z.device


def _suffix(dtype):
    return "f32" if dtype == torch.float32 else "bf16"


def gat_fwd(job_offsets, w_blocks, u_senders, z, src, dst_rows,
            negative_slope: float, out: Optional[torch.Tensor] = None):
    """K4: (out (tiles*TN, H, O) in z's dtype, m, l (tiles*TN, H) fp32)
    in kernel row order from z (N, H, O), src (N, H) and dst_rows
    (tiles*TN, H); the attention output is written into ``out`` when
    given."""
    global launches_fwd
    if _device(z, "gat_fwd").type == "cpu":
        res, m, l = gat_fwd_reference(job_offsets, w_blocks, u_senders, z,
                                      src, dst_rows, negative_slope)
        return (res if out is None else out.copy_(res)), m, l
    dev = z.device
    num_tiles = job_offsets.shape[0] - 1
    rows = num_tiles * TILE_ROWS
    if z.dim() != 3:
        raise ValueError(f"gat_fwd expects z (N, H, O), got {tuple(z.shape)}")
    n, heads, o = z.shape
    _check_layout("gat_fwd", job_offsets, w_blocks, u_senders, dev)
    _check("gat_fwd", (job_offsets, w_blocks, u_senders), {
        "z": (z, z.shape, _FEAT), "src": (src, (n, heads), _F32),
        "dst_rows": (dst_rows, (rows, heads), _F32)}, dev)
    if out is None:
        out = torch.empty((rows, heads, o), dtype=z.dtype, device=dev)
    _check("gat_fwd", (), {"out": (out, (rows, heads, o), (z.dtype,))}, dev)
    m = torch.empty((rows, heads), dtype=torch.float32, device=dev)
    l = torch.empty((rows, heads), dtype=torch.float32, device=dev)
    fn = getattr(_load(), f"gat_fwd_{_suffix(z.dtype)}")
    err = fn(job_offsets.data_ptr(), w_blocks.data_ptr(),
             u_senders.data_ptr(), z.data_ptr(), src.data_ptr(),
             dst_rows.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
             num_tiles, heads, o, float(negative_slope),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"gat_fwd launch failed: CUDA error {err}")
    launches_fwd += 1
    return out, m, l


def gat_bwd_b1(job_offsets, w_blocks, u_senders, g_rows, z, dst_rows, src,
               m_rows, l_rows, c_rows, negative_slope: float):
    """K5: ddst (tiles*TN,) fp32 in kernel row order of the forward
    layout; g_rows (tiles*TN, D) fp32, z (N, D)."""
    global launches_b1
    if _device(z, "gat_bwd_b1").type == "cpu":
        return gat_bwd_b1_reference(job_offsets, w_blocks, u_senders, g_rows,
                                    z, dst_rows, src, m_rows, l_rows, c_rows,
                                    negative_slope)
    dev = z.device
    num_tiles = job_offsets.shape[0] - 1
    rows = num_tiles * TILE_ROWS
    if z.dim() != 2:
        raise ValueError(f"gat_bwd_b1 expects z (N, D), got "
                         f"{tuple(z.shape)}")
    n, d = z.shape
    _check_layout("gat_bwd_b1", job_offsets, w_blocks, u_senders, dev)
    _check("gat_bwd_b1", (job_offsets, w_blocks, u_senders), {
        "z": (z, z.shape, _FEAT), "g_rows": (g_rows, (rows, d), _F32),
        "dst_rows": (dst_rows, (rows,), _F32), "src": (src, (n,), _F32),
        "m_rows": (m_rows, (rows,), _F32), "l_rows": (l_rows, (rows,), _F32),
        "c_rows": (c_rows, (rows,), _F32)}, dev)
    ddst = torch.zeros(rows, dtype=torch.float32, device=dev)
    fn = getattr(_load(), f"gat_bwd_b1_{_suffix(z.dtype)}")
    err = fn(job_offsets.data_ptr(), w_blocks.data_ptr(),
             u_senders.data_ptr(), g_rows.data_ptr(), z.data_ptr(),
             dst_rows.data_ptr(), src.data_ptr(), m_rows.data_ptr(),
             l_rows.data_ptr(), c_rows.data_ptr(), ddst.data_ptr(),
             num_tiles, d, float(negative_slope),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"gat_bwd_b1 launch failed: CUDA error {err}")
    launches_b1 += 1
    return ddst


def gat_bwd_b2(job_offsets, w_blocks, u_senders, z_rows, src_rows, g, dst,
               m, l, c, negative_slope: float):
    """K6: (dz (tiles*TN, D) in z_rows' dtype, dsrc (tiles*TN,) fp32) in
    kernel row order of the transpose layout; g (N, D) and dst, m, l, c
    (N,) fp32 in node order."""
    global launches_b2
    if _device(z_rows, "gat_bwd_b2").type == "cpu":
        return gat_bwd_b2_reference(job_offsets, w_blocks, u_senders, z_rows,
                                    src_rows, g, dst, m, l, c,
                                    negative_slope)
    dev = z_rows.device
    num_tiles = job_offsets.shape[0] - 1
    rows = num_tiles * TILE_ROWS
    if g.dim() != 2:
        raise ValueError(f"gat_bwd_b2 expects g (N, D), got "
                         f"{tuple(g.shape)}")
    n, d = g.shape
    _check_layout("gat_bwd_b2", job_offsets, w_blocks, u_senders, dev)
    _check("gat_bwd_b2", (job_offsets, w_blocks, u_senders), {
        "z_rows": (z_rows, (rows, d), _FEAT),
        "src_rows": (src_rows, (rows,), _F32), "g": (g, (n, d), _F32),
        "dst": (dst, (n,), _F32), "m": (m, (n,), _F32),
        "l": (l, (n,), _F32), "c": (c, (n,), _F32)}, dev)
    # K6 writes every element of both (no atomics, no zeroed output)
    dz = torch.empty((rows, d), dtype=z_rows.dtype, device=dev)
    dsrc = torch.empty(rows, dtype=torch.float32, device=dev)
    fn = getattr(_load(), f"gat_bwd_b2_{_suffix(z_rows.dtype)}")
    err = fn(job_offsets.data_ptr(), w_blocks.data_ptr(),
             u_senders.data_ptr(), z_rows.data_ptr(), src_rows.data_ptr(),
             g.data_ptr(), dst.data_ptr(), m.data_ptr(), l.data_ptr(),
             c.data_ptr(), dz.data_ptr(), dsrc.data_ptr(), num_tiles, d,
             float(negative_slope),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"gat_bwd_b2 launch failed: CUDA error {err}")
    launches_b2 += 1
    return dz, dsrc


# ---------------------------------------------------------------------------
# Node order <-> kernel row order, forward and fused backward
# ---------------------------------------------------------------------------


def _to_rows(t: DedupTiles, vec: torch.Tensor) -> torch.Tensor:
    """Node-order values -> kernel row order (``_rows_order``); rows
    without a node are zero."""
    out = vec.new_zeros((t.num_tiles * t.tile_rows,) + tuple(vec.shape[1:]))
    if t.pos is not None:
        out[t.pos.long()] = vec
    else:
        out[:vec.shape[0]] = vec
    return out


def _to_nodes(t: DedupTiles, rows: torch.Tensor, n: int) -> torch.Tensor:
    return rows.index_select(0, t.pos) if t.pos is not None else rows[:n]


def _forward_mh(t: DedupTiles, n: int, z, src, dst, negative_slope):
    """z (n, H, O), src/dst (n, H) -> (out (n, H, O), m, l (rows, H) in
    kernel row order)."""
    out, m, l = gat_fwd(t.job_offsets, t.w_blocks, t.u_senders,
                        z.contiguous(), src.float().contiguous(),
                        _to_rows(t, dst.float()), negative_slope)
    return _to_nodes(t, out, n), m, l


def _backward_head(graph: Graph, z, src, dst, out, m_rows, l_rows, g,
                   negative_slope):
    """``_gat_dedup_backward_fused`` for one head: K5 on the forward
    layout, K6 on the transpose layout -> (dz, dsrc, ddst)."""
    tf, tt, n = graph.dedup, graph.dedup_t, graph.n_nodes
    gf = g.float().contiguous()
    c = (out.float() * gf).sum(dim=1)
    ddst_rows = gat_bwd_b1(
        tf.job_offsets, tf.w_blocks, tf.u_senders, _to_rows(tf, gf),
        z.contiguous(), _to_rows(tf, dst.float()), src.float().contiguous(),
        m_rows.contiguous(), l_rows.contiguous(), _to_rows(tf, c),
        negative_slope)
    dz_rows, dsrc_rows = gat_bwd_b2(
        tt.job_offsets, tt.w_blocks, tt.u_senders, _to_rows(tt, z),
        _to_rows(tt, src.float()), gf, dst.float().contiguous(),
        _to_nodes(tf, m_rows, n).contiguous(),
        _to_nodes(tf, l_rows, n).contiguous(), c, negative_slope)
    return (_to_nodes(tt, dz_rows, n),
            _to_nodes(tt, dsrc_rows, n).to(src.dtype),
            _to_nodes(tf, ddst_rows, n).to(dst.dtype))


_GAT_BACKWARD = "fused"


def set_gat_backward(mode: str) -> None:
    """The backward of both attention modules, as the JAX package's one
    ``_GAT_BACKWARD`` is: ``"fused"`` (default) runs K5 and K6 per head
    here and K8 and K9 per head in :mod:`gist_tpu_torch.ops.gat_tiled`;
    ``"xla"`` recomputes the attention with the segment composite and
    differentiates it (exact, the reference)."""
    global _GAT_BACKWARD
    if mode not in ("fused", "xla"):
        raise ValueError(f"GAT backward must be 'fused' or 'xla', not "
                         f"{mode!r}")
    _GAT_BACKWARD = mode


class _GATDedup(torch.autograd.Function):
    """All-heads dedup attention: K4 forward (out, m, l); the backward
    takes gradients of z, src and dst (the layouts take none)."""

    @staticmethod
    def forward(ctx, z, src, dst, graph: Graph, negative_slope: float):
        out, m, l = _forward_mh(graph.dedup, graph.n_nodes, z, src, dst,
                                negative_slope)
        ctx.save_for_backward(z, src, dst, out, m, l)
        ctx.graph, ctx.negative_slope = graph, negative_slope
        return out

    @staticmethod
    def backward(ctx, g):
        z, src, dst, out, m, l = ctx.saved_tensors
        graph, slope = ctx.graph, ctx.negative_slope
        if _GAT_BACKWARD == "fused":
            parts = [_backward_head(graph, z[:, h], src[:, h], dst[:, h],
                                    out[:, h], m[:, h], l[:, h], g[:, h],
                                    slope)
                     for h in range(z.shape[1])]
            dz, dsrc, ddst = (torch.stack(p, dim=1) for p in zip(*parts))
        else:
            from gist_tpu_torch.ops.segment import gat_attention_segment
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(True)
                          for t in (z, src, dst)]
                ref = gat_attention_segment(graph, *leaves, slope)
                dz, dsrc, ddst = torch.autograd.grad(ref, leaves, g)
        return dz, dsrc, ddst, None, None


def _require_layouts(graph: Graph) -> None:
    if graph.dedup is None or graph.dedup_t is None:
        raise ValueError("graph carries no dedup layout pair (build it "
                         "with tiles=True)")


def gat_attention_dedup_mh(graph: Graph, z: torch.Tensor, src_score,
                           dst_score, negative_slope: float = 0.01):
    """All-heads fused dedup attention: z (N, H, O), per-node score
    halves (N, H) -> (N, H, O), one K4 launch for every head."""
    _require_layouts(graph)
    return _GATDedup.apply(z, src_score, dst_score, graph, negative_slope)


def gat_attention_dedup(graph: Graph, z: torch.Tensor, src_score,
                        dst_score, negative_slope: float = 0.01):
    """Single-head fused dedup attention: z (N, O), scores (N,) -> (N, O);
    K4 with H = 1."""
    _require_layouts(graph)
    return _GATDedup.apply(z[:, None], src_score[:, None],
                           dst_score[:, None], graph, negative_slope)[:, 0]


# ---------------------------------------------------------------------------
# The chunked layout: K4 once per chunk, the composite backward
# ---------------------------------------------------------------------------


def _forward_chunked(t: ChunkedDedupTiles, n: int, z, src, dst,
                     negative_slope):
    """``_mh_tiles_raw_chunked``: z (n, H, O), src/dst (n, H) -> out
    (n, H, O).  z and the source scores are permuted once (the chunks'
    slots index ``z[perm]``), the destination scores scattered into
    kernel rows by ``pos``; chunks partition the destination tiles, so
    each row's whole softmax lives in one chunk, and K4 writes each
    chunk into its slice of one output."""
    rows = t.tiles_per_chunk * t.tile_rows
    heads = z.shape[1]
    if t.perm is not None:
        z, src = z.index_select(0, t.perm), src.index_select(0, t.perm)
    z, src = z.contiguous(), src.float().contiguous()
    dst_rows = dst.new_zeros((t.n_chunks * rows, heads), dtype=torch.float32)
    if t.pos is not None:
        dst_rows[t.pos.long()] = dst.float()
    else:
        dst_rows[:n] = dst.float()
    out = z.new_empty((t.n_chunks * rows, heads, z.shape[2]))
    for c in range(t.n_chunks):
        part = slice(c * rows, (c + 1) * rows)
        gat_fwd(t.job_offsets[c], t.w_blocks[c], t.u_senders[c], z, src,
                dst_rows[part], negative_slope, out=out[part])
    return out.index_select(0, t.pos) if t.pos is not None else out[:n]


class _GATDedupChunked(torch.autograd.Function):
    """All-heads attention over ``graph.dedup_c``.  The backward
    recomputes the attention with the segment composite and
    differentiates it, one head at a time (full-graph GAT at this scale
    is an eval path in the JAX package)."""

    @staticmethod
    def forward(ctx, z, src, dst, graph: Graph, negative_slope: float):
        ctx.save_for_backward(z, src, dst)
        ctx.graph, ctx.negative_slope = graph, negative_slope
        return _forward_chunked(graph.dedup_c, graph.n_nodes, z, src, dst,
                                negative_slope)

    @staticmethod
    def backward(ctx, g):
        from gist_tpu_torch.ops.segment import gat_attention_segment
        z, src, dst = ctx.saved_tensors
        parts = []
        with torch.enable_grad():
            for h in range(z.shape[1]):
                leaves = [t[:, h].detach().requires_grad_(True)
                          for t in (z, src, dst)]
                ref = gat_attention_segment(ctx.graph, *leaves,
                                            ctx.negative_slope)
                parts.append(torch.autograd.grad(ref, leaves, g[:, h]))
        dz, dsrc, ddst = (torch.stack(p, dim=1) for p in zip(*parts))
        return dz, dsrc, ddst, None, None


def gat_attention_dedup_chunked(graph: Graph, z: torch.Tensor, src_score,
                                dst_score, negative_slope: float = 0.01):
    """All-heads dedup attention over the chunked layout
    (``gist_tpu/ops/pallas_gat.py:gat_attention_dedup_chunked``): z
    (N, H, O), scores (N, H) -> (N, H, O), one K4 launch per chunk."""
    if graph.dedup_c is None:
        raise ValueError("graph carries no chunked dedup layout (build it "
                         "with with_tiles(mode='dedup-chunked'))")
    if graph.dedup_c.is_dir is not None:
        raise ValueError("the chunked attention takes the chunked layout, "
                         "not the split one")
    return _GATDedupChunked.apply(z, src_score, dst_score, graph,
                                  negative_slope)
