"""K7, K8, K9: single-head GAT attention over the v1 gather layout as
hand-written CUDA kernels, with their plain PyTorch versions and the
fused backward.

Counterpart of the v1 half of ``gist_tpu/ops/pallas_gat.py``
(``_gat_kernel``, ``_gat_bwd_b1_kernel``, ``_gat_bwd_b2_kernel``,
``gat_attention_pallas`` and ``_gat_backward_fused``).  The kernel
source is ``gist_tpu_torch/csrc/gat_tiled.cu`` (its row walk in
``csrc/tiled_rows.cuh``); it is compiled by ``nvcc`` for ``sm_90a`` into
``gist_tpu_torch/_build/`` at first use and loaded with ctypes, as K1 is.

The three wrappers (:func:`gat_tiled_fwd`, :func:`gat_tiled_bwd_b1`,
:func:`gat_tiled_bwd_b2`) take the layout, per-node arrays in node order
and per-row arrays over the layout's ``num_tiles * tile_rows`` rows.
Each launches its kernel for CUDA tensors (or raises) and runs its plain
version (the TPU kernel's walk over tiles and chunk-slot blocks) for CPU
tensors; ``launches_fwd``, ``launches_b1`` and ``launches_b2`` count the
launches.  Each launches with a plan chosen on the host from D and the
alignment (:func:`fwd_plan`, :func:`b1_plan`, :func:`b2_plan`), as K3
does; :func:`run_fwd_plan`, :func:`run_b1_plan` and :func:`run_b2_plan`
launch another plan for a measurement.

:func:`gat_attention_tiled` is differentiable.  Its backward runs K8 on
the forward layout, then K9 on the transpose layout, when the backward
mode is ``"fused"`` (``gat_dedup.set_gat_backward``, the one switch of
both attention modules) and the graph carries ``tiled_t`` and
``pos_in_other``; otherwise it is autograd through the segment
composite, as the JAX package's ``"xla"`` mode is.
"""

from __future__ import annotations

import ctypes
import os

import torch

from gist_tpu_torch.graph import Graph, TiledCSR
from gist_tpu_torch.ops import dedup_spmm, gat_dedup
from gist_tpu_torch.ops.gat_dedup import (_F32, _FEAT, NEG_INF, _check,
                                          _device, _lrelu, _suffix)
from gist_tpu_torch.ops.tiled_spmm import (Plan, check_layout, local_rows,
                                            tile_chunks, vec_width)

SOURCE = os.path.join(os.path.dirname(dedup_spmm.SOURCE), "gat_tiled.cu")

launches_fwd = 0
launches_b1 = 0
launches_b2 = 0
_lib = None

# the kernels' instances (csrc/gat_tiled.cu): lanes per group, vectors a
# lane, and the fp32 values a lane may hold (K7's and K9's accumulators,
# K8's columns of G_r)
GROUPS = (16, 8)
PER_LANE = (1, 2, 3, 4, 6, 8)
FWD_MAX = 8
B1_MAX = 16
B2_MAX = 16


def reset_launches() -> None:
    global launches_fwd, launches_b1, launches_b2
    launches_fwd = launches_b1 = launches_b2 = 0


def _load():
    global _lib
    if _lib is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        sigs = {"gat_tiled_fwd": [p] * 9 + [i, i, i, f] + [i] * 4 + [p],
                "gat_tiled_bwd_b1": [p] * 11 + [i, i, i, f] + [i] * 4 + [p],
                "gat_tiled_bwd_b2": [p] * 12 + [i, i, i, f] + [i] * 4 + [p]}
        _lib = dedup_spmm.load_library(SOURCE, {
            f"{name}_{suffix}": args for name, args in sigs.items()
            for suffix in ("f32", "bf16")})
    return _lib


# ---------------------------------------------------------------------------
# Launch plans of K7, K8 and K9
# ---------------------------------------------------------------------------


def _per_lane(nv: int, group: int, vec: int, most: int) -> int:
    """The fewest vectors a lane, among the kernel's instances, that
    cover ``nv`` vectors with ``group`` lanes; at most ``most`` fp32
    values a lane."""
    cap = max(c for c in PER_LANE if c * vec <= most)
    return min([c for c in PER_LANE if c >= -(-nv // group)] + [cap])


def _group(nv: int, vec: int, most: int) -> int:
    """Groups of 8 lanes where 8 lanes can hold a row of ``nv`` vectors
    (at most ``most`` values a lane), else 16."""
    return 8 if nv <= 8 * _per_lane(nv, 8, vec, most) else 16


def fwd_plan(d: int, vec: int) -> Plan:
    """The plan K7 launches at width ``d`` with ``vec``-element loads:
    one warp per row with its groups on successive slots, groups of 8
    lanes where 8 lanes can hold the row within ``FWD_MAX`` accumulators
    a lane, else 16, each lane holding the fewest vectors that cover the
    row (a wider row takes one block column per ``span`` columns).
    Chosen by measurement on an H100 (``chip_smoke.py`` phase
    ``v1_gat_plans``; PERF.md): at D=41 this plan (8 lanes) was the
    fastest by 14%; at D=512 (16 lanes, four block columns of 128) it
    was the fastest of the plan space in three runs out of three, 0.7-0.8%
    ahead of the next."""
    nv = -(-d // vec)
    group = _group(nv, vec, FWD_MAX)
    return Plan(False, group, _per_lane(nv, group, vec, FWD_MAX), vec)


def plan_space(d: int, vec: int, most: int) -> list:
    """Every plan with an instance at width ``d`` and ``vec``-element
    loads whose lanes hold at most ``most`` values and no more vectors
    than cover the row: both modes, groups of 8 and 16 lanes, from one
    vector a lane to the fewest that cover the row (the plans a
    measurement compares)."""
    nv = -(-d // vec)
    return [Plan(rows, group, c, vec) for rows in (False, True)
            for group in GROUPS for c in PER_LANE
            if c <= _per_lane(nv, group, vec, most)]


def b1_plan(d: int, vec: int) -> Plan:
    """The plan K8 launches at width ``d`` with ``vec``-element loads:
    each group of lanes on a row of its own, groups of 8 lanes where 8
    lanes can hold the row's G_r within ``B1_MAX`` values a lane, else
    16, each lane holding the fewest vectors that cover the row (a wider
    row is walked once per chunk of ``span`` columns).  Chosen by
    measurement on an H100 (``chip_smoke.py`` phase ``v1_gat_plans``;
    PERF.md): rows mode won at D=41 (8 lanes) and at D=512 (16 lanes,
    two chunks of 256), where all of G_r in 32 values a lane had lost
    1.6x to register pressure."""
    nv = -(-d // vec)
    group = _group(nv, vec, B1_MAX)
    return Plan(True, group, _per_lane(nv, group, vec, B1_MAX), vec)


def b2_plan(d: int, vec: int) -> Plan:
    """The plan K9 launches at width ``d`` with ``vec``-element loads:
    each group of lanes on a row of its own; groups of 16 lanes where 16
    lanes hold the row in one block column within ``B2_MAX``
    accumulators a lane, each lane holding the fewest vectors that cover
    it, else groups of 8 lanes with as many vectors as a lane may hold
    (a block column per ``span`` columns).  Chosen by measurement on an
    H100 (``chip_smoke.py`` phase ``v1_gat_plans``; PERF.md): at D=41
    16 lanes x 3 values were the fastest of the plan space by 11% (K7's
    plan, one warp per row in groups of 8 x 6, came second); at D=512, 8
    lanes x 4 float4 over four block columns of 128 led the next plan
    (16 x 3 float4, three columns) by 1.2% and the best with at most 8
    accumulators a lane by 2.3%."""
    nv = -(-d // vec)
    per16 = _per_lane(nv, 16, vec, B2_MAX)
    if 16 * per16 >= nv:
        return Plan(True, 16, per16, vec)
    return Plan(True, 8, _per_lane(nv, 8, vec, B2_MAX), vec)


# ---------------------------------------------------------------------------
# Plain versions: the TPU kernels' walk over tiles and chunks in PyTorch
# ---------------------------------------------------------------------------


def _alpha(raw, m_r, l_r, negative_slope):
    """exp(min(score - m, 0)) / l (0 where l = 0) and lrelu'(raw)."""
    e = _lrelu(raw, negative_slope)
    a = torch.where(l_r > 0, torch.exp(torch.clamp(e - m_r, max=0.0))
                    / l_r.clamp(min=1e-20), 0.0)
    return a, torch.where(raw > 0, 1.0, negative_slope)


def gat_tiled_fwd_reference(t: TiledCSR, z, src, dst, negative_slope):
    """K7's plain version: per tile, the exact row max over its chunks,
    then the softmax sums.  z (N, D), src and dst (N,) fp32 -> (out
    (rows, D) in z's dtype, m, l (rows,) fp32)."""
    tn, n = t.tile_rows, z.shape[0]
    rows = t.num_tiles * tn
    dev = z.device
    zf = z.float()
    out = torch.zeros((rows, z.shape[1]), dtype=torch.float32, device=dev)
    m = torch.full((rows,), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(rows, dtype=torch.float32, device=dev)
    for i, chunks in tile_chunks(t):
        if not chunks:
            continue
        parts = []
        mx = torch.full((tn + 1,), NEG_INF, dtype=torch.float32, device=dev)
        for sl in chunks:
            local = local_rows(t, i, sl)
            s = t.senders[sl].long()
            sc = _lrelu(src[s] + dst[t.receivers[sl].long().clamp(max=n - 1)],
                        negative_slope)
            mx.scatter_reduce_(0, local, sc, reduce="amax")
            parts.append((local, s, sc))
        acc = torch.zeros((tn + 1, z.shape[1]), device=dev)
        ssum = torch.zeros(tn + 1, device=dev)
        for local, s, sc in parts:
            p = torch.where(local < tn, torch.exp(sc - mx[local]), 0.0)
            ssum.index_add_(0, local, p)
            acc.index_add_(0, local, p[:, None] * zf[s])
        blk = slice(i * tn, (i + 1) * tn)
        out[blk] = torch.where(ssum[:tn, None] > 0,
                               acc[:tn] / ssum[:tn, None].clamp(min=1e-20),
                               0.0)
        m[blk], l[blk] = mx[:tn], ssum[:tn]
    return out.to(z.dtype), m, l


def gat_tiled_bwd_b1_reference(t: TiledCSR, z, src, dst, m, l, g,
                               negative_slope):
    """K8's plain version over the forward layout: per row
    ``c_r = sum alpha dalpha`` (the value of ``out_r . G_r``), then per
    slot ``ds = alpha (dalpha - c_r) lrelu'`` (0 on padding slots) and
    per row ``ddst_r = sum ds``.  z (N, D); src, dst (N,); m, l (rows,);
    g (N, D) fp32 -> (ds (E_t,), ddst (rows,)) fp32."""
    tn, n = t.tile_rows, z.shape[0]
    dev = z.device
    zf = z.float()
    ds = torch.zeros(t.senders.shape[0], dtype=torch.float32, device=dev)
    ddst = torch.zeros(t.num_tiles * tn, dtype=torch.float32, device=dev)
    for i, chunks in tile_chunks(t):
        c = torch.zeros(tn + 1, device=dev)
        parts = []
        for sl in chunks:
            local = local_rows(t, i, sl)
            s = t.senders[sl].long()
            r = t.receivers[sl].long()
            rn = r.clamp(max=n - 1)
            rr = r.clamp(max=m.shape[0] - 1)
            a, gp = _alpha(src[s] + dst[rn], m[rr], l[rr], negative_slope)
            a = torch.where(local < tn, a, 0.0)
            dalpha = (zf[s] * g[rn]).sum(dim=1)
            c.index_add_(0, local, a * dalpha)
            parts.append((sl, local, a, gp, dalpha))
        acc = torch.zeros(tn + 1, device=dev)
        for sl, local, a, gp, dalpha in parts:
            d = a * (dalpha - c[local]) * gp
            ds[sl] = d
            acc.index_add_(0, local, d)
        ddst[i * tn:(i + 1) * tn] = acc[:tn]
    return ds, ddst


def gat_tiled_bwd_b2_reference(t: TiledCSR, ds, g, src, dst, m, l,
                               negative_slope, dtype=torch.float32):
    """K9's plain version over the transpose layout (rows are original
    senders s, slot senders original receivers r): ``dz_s = sum alpha
    G_r`` in ``dtype`` and ``dsrc_s = sum ds`` (fp32), ds taken from the
    forward layout's slots through ``pos_in_other``; padding slots count
    as zero."""
    tn, n = t.tile_rows, src.shape[0]
    dev = g.device
    rows = t.num_tiles * tn
    dz = torch.zeros((rows, g.shape[1]), dtype=torch.float32, device=dev)
    dsrc = torch.zeros(rows, dtype=torch.float32, device=dev)
    for i, chunks in tile_chunks(t):
        accz = torch.zeros((tn + 1, g.shape[1]), device=dev)
        accs = torch.zeros(tn + 1, device=dev)
        for sl in chunks:
            local = local_rows(t, i, sl)
            valid = local < tn
            s = t.receivers[sl].long().clamp(max=n - 1)
            r = t.senders[sl].long()
            a, _ = _alpha(src[s] + dst[r], m[r], l[r], negative_slope)
            a = torch.where(valid, a, 0.0)
            dsv = torch.where(valid, ds[t.pos_in_other[sl].long()], 0.0)
            accz.index_add_(0, local, a[:, None] * g[r])
            accs.index_add_(0, local, dsv)
        blk = slice(i * tn, (i + 1) * tn)
        dz[blk], dsrc[blk] = accz[:tn], accs[:tn]
    return dz.to(dtype), dsrc


# ---------------------------------------------------------------------------
# Wrappers: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def gat_tiled_fwd(t: TiledCSR, z, src, dst, negative_slope: float):
    """K7: (out (rows, D) in z's dtype, m, l (rows,) fp32) from z (N, D)
    and the score halves src, dst (N,) fp32."""
    if _device(z, "gat_tiled_fwd").type == "cpu":
        return gat_tiled_fwd_reference(t, z, src, dst, negative_slope)
    return run_fwd_plan(t, z, src, dst, negative_slope, None)


def _cuda(name, z, what="z"):
    if z.device.type != "cuda":
        raise ValueError(f"{name} launches on cuda tensors, not {z.device}")
    if z.dim() != 2:
        raise ValueError(f"{name} expects {what} (N, D), got "
                         f"{tuple(z.shape)}")
    return z.device


def _plan_vec(name, plan, vec):
    if vec % plan.vec:
        raise ValueError(f"{name}: plan {plan} needs {plan.vec}-element "
                         f"alignment; D and the tensors allow {vec}")
    return plan


def run_fwd_plan(t: TiledCSR, z, src, dst, negative_slope: float, plan):
    """One K7 launch on CUDA tensors with ``plan`` (None:
    :func:`fwd_plan`'s).  The path calls it through
    :func:`gat_tiled_fwd`; a measurement may pass another plan."""
    global launches_fwd
    dev = _cuda("gat_tiled_fwd", z)
    n, d = z.shape
    check_layout("gat_tiled_fwd", t, dev)
    _check("gat_tiled_fwd", (), {"z": (z, z.shape, _FEAT),
                                  "src": (src, (n,), _F32),
                                  "dst": (dst, (n,), _F32)}, dev)
    rows = t.num_tiles * t.tile_rows
    out = torch.empty((rows, d), dtype=z.dtype, device=dev)
    m = torch.empty(rows, dtype=torch.float32, device=dev)
    l = torch.empty(rows, dtype=torch.float32, device=dev)
    vec = vec_width(d, z.element_size(), z.data_ptr(), out.data_ptr())
    plan = fwd_plan(d, vec) if plan is None else \
        _plan_vec("gat_tiled_fwd", plan, vec)
    fn = getattr(_load(), f"gat_tiled_fwd_{_suffix(z.dtype)}")
    err = fn(t.tile_offsets.data_ptr(), t.senders.data_ptr(),
             t.receivers.data_ptr(), z.data_ptr(), src.data_ptr(),
             dst.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
             rows, t.tile_rows, d, float(negative_slope), int(plan.rows),
             plan.group, plan.per_lane, plan.vec, _stream(dev))
    if err:
        raise RuntimeError(f"gat_tiled_fwd launch failed with plan {plan}: "
                           f"CUDA error {err}")
    launches_fwd += 1
    return out, m, l


def gat_tiled_bwd_b1(t: TiledCSR, z, src, dst, m, l, g,
                     negative_slope: float):
    """K8: (ds (E_t,), ddst (rows,)) fp32 over the forward layout; z
    (N, D), src, dst (N,) fp32, m, l (rows,) fp32, g (N, D) fp32."""
    if _device(z, "gat_tiled_bwd_b1").type == "cpu":
        return gat_tiled_bwd_b1_reference(t, z, src, dst, m, l, g,
                                          negative_slope)
    return run_b1_plan(t, z, src, dst, m, l, g, negative_slope, None)


def run_b1_plan(t: TiledCSR, z, src, dst, m, l, g, negative_slope: float,
                plan):
    """One K8 launch on CUDA tensors with ``plan`` (None:
    :func:`b1_plan`'s).  The path calls it through
    :func:`gat_tiled_bwd_b1`; a measurement may pass another plan."""
    global launches_b1
    dev = _cuda("gat_tiled_bwd_b1", z)
    n, d = z.shape
    rows = t.num_tiles * t.tile_rows
    check_layout("gat_tiled_bwd_b1", t, dev)
    _check("gat_tiled_bwd_b1", (), {
        "z": (z, z.shape, _FEAT), "src": (src, (n,), _F32),
        "dst": (dst, (n,), _F32), "m": (m, (rows,), _F32),
        "l": (l, (rows,), _F32), "g": (g, (n, d), _F32)}, dev)
    vec = min(vec_width(d, z.element_size(), z.data_ptr()),
              vec_width(d, 4, g.data_ptr()))
    plan = b1_plan(d, vec) if plan is None else \
        _plan_vec("gat_tiled_bwd_b1", plan, vec)
    ds = torch.zeros(t.senders.shape[0], dtype=torch.float32, device=dev)
    ddst = torch.empty(rows, dtype=torch.float32, device=dev)
    fn = getattr(_load(), f"gat_tiled_bwd_b1_{_suffix(z.dtype)}")
    err = fn(t.tile_offsets.data_ptr(), t.senders.data_ptr(),
             t.receivers.data_ptr(), z.data_ptr(), src.data_ptr(),
             dst.data_ptr(), m.data_ptr(), l.data_ptr(), g.data_ptr(),
             ds.data_ptr(), ddst.data_ptr(), rows, t.tile_rows, d,
             float(negative_slope), int(plan.rows), plan.group,
             plan.per_lane, plan.vec, _stream(dev))
    if err:
        raise RuntimeError(f"gat_tiled_bwd_b1 launch failed with plan "
                           f"{plan}: CUDA error {err}")
    launches_b1 += 1
    return ds, ddst


def gat_tiled_bwd_b2(t: TiledCSR, ds, g, src, dst, m, l,
                     negative_slope: float, dtype=torch.float32):
    """K9: (dz (rows_t, D) in ``dtype``, dsrc (rows_t,) fp32) over the
    transpose layout ``t``; ds (E_t of the forward layout), g (N, D),
    src, dst (N,), m, l (forward rows,), all fp32."""
    if _device(g, "gat_tiled_bwd_b2").type == "cpu":
        return gat_tiled_bwd_b2_reference(t, ds, g, src, dst, m, l,
                                          negative_slope, dtype)
    return run_b2_plan(t, ds, g, src, dst, m, l, negative_slope, None,
                       dtype)


def run_b2_plan(t: TiledCSR, ds, g, src, dst, m, l, negative_slope: float,
                plan, dtype=torch.float32):
    """One K9 launch on CUDA tensors with ``plan`` (None:
    :func:`b2_plan`'s).  The path calls it through
    :func:`gat_tiled_bwd_b2`; a measurement may pass another plan."""
    global launches_b2
    dev = _cuda("gat_tiled_bwd_b2", g, "g")
    if dtype not in _FEAT:
        raise TypeError(f"gat_tiled_bwd_b2: dz must be one of {_FEAT}, not "
                        f"{dtype}")
    n, d = g.shape
    if m.shape[0] < n:
        raise ValueError(f"gat_tiled_bwd_b2: m and l need a row per node, "
                         f"got {m.shape[0]} for {n} nodes")
    check_layout("gat_tiled_bwd_b2", t, dev,
                 ("tile_offsets", "senders", "receivers", "pos_in_other"))
    _check("gat_tiled_bwd_b2", (), {
        "ds": (ds, ds.shape, _F32), "g": (g, g.shape, _F32),
        "src": (src, (n,), _F32), "dst": (dst, (n,), _F32),
        "m": (m, m.shape, _F32), "l": (l, m.shape, _F32)}, dev)
    rows = t.num_tiles * t.tile_rows
    dz = torch.empty((rows, d), dtype=dtype, device=dev)
    dsrc = torch.empty(rows, dtype=torch.float32, device=dev)
    vec = min(vec_width(d, 4, g.data_ptr()),
              vec_width(d, dz.element_size(), dz.data_ptr()))
    plan = b2_plan(d, vec) if plan is None else \
        _plan_vec("gat_tiled_bwd_b2", plan, vec)
    fn = getattr(_load(), f"gat_tiled_bwd_b2_{_suffix(dtype)}")
    err = fn(t.tile_offsets.data_ptr(), t.senders.data_ptr(),
             t.receivers.data_ptr(), t.pos_in_other.data_ptr(),
             ds.data_ptr(), g.data_ptr(), src.data_ptr(), dst.data_ptr(),
             m.data_ptr(), l.data_ptr(), dz.data_ptr(), dsrc.data_ptr(),
             rows, t.tile_rows, d, float(negative_slope), int(plan.rows),
             plan.group, plan.per_lane, plan.vec, _stream(dev))
    if err:
        raise RuntimeError(f"gat_tiled_bwd_b2 launch failed with plan "
                           f"{plan}: CUDA error {err}")
    launches_b2 += 1
    return dz, dsrc


# ---------------------------------------------------------------------------
# The differentiable attention
# ---------------------------------------------------------------------------


def _backward_fused(graph: Graph, z, src, dst, m, l, g, slope):
    """``_gat_backward_fused``: K8 on ``tiled`` (per-slot ds, ddst), then
    K9 on ``tiled_t`` (dz, dsrc) -> node-order (dz, dsrc, ddst).  K8
    sums ``c_r`` itself, so the forward output is not needed."""
    n = graph.n_nodes
    gf = g.float().contiguous()
    srcf, dstf = src.float().contiguous(), dst.float().contiguous()
    ds, ddst = gat_tiled_bwd_b1(graph.tiled, z, srcf, dstf, m, l, gf,
                                slope)
    dz, dsrc = gat_tiled_bwd_b2(graph.tiled_t, ds, gf, srcf, dstf, m, l,
                                slope, z.dtype)
    return dz[:n], dsrc[:n].to(src.dtype), ddst[:n].to(dst.dtype)


class _GATTiled(torch.autograd.Function):
    """Single-head attention over ``graph.tiled``: K7 forward (out, m,
    l); the backward takes gradients of z, src and dst."""

    @staticmethod
    def forward(ctx, z, src, dst, graph: Graph, negative_slope: float):
        z = z.contiguous()
        out, m, l = gat_tiled_fwd(graph.tiled, z, src.float().contiguous(),
                                  dst.float().contiguous(), negative_slope)
        ctx.save_for_backward(z, src, dst, m, l)
        ctx.graph, ctx.negative_slope = graph, negative_slope
        return out[:graph.n_nodes]

    @staticmethod
    def backward(ctx, g):
        z, src, dst, m, l = ctx.saved_tensors
        graph, slope = ctx.graph, ctx.negative_slope
        if (gat_dedup._GAT_BACKWARD == "fused" and graph.tiled_t is not None
                and graph.tiled.pos_in_other is not None
                and graph.tiled_t.pos_in_other is not None):
            dz, dsrc, ddst = _backward_fused(graph, z, src, dst, m, l, g,
                                             slope)
        else:
            from gist_tpu_torch.ops.segment import gat_attention_segment
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(True)
                          for t in (z, src, dst)]
                ref = gat_attention_segment(graph, *leaves, slope)
                dz, dsrc, ddst = torch.autograd.grad(ref, leaves, g)
        return dz, dsrc, ddst, None, None


def gat_attention_tiled(graph: Graph, z: torch.Tensor, src_score,
                        dst_score, negative_slope: float = 0.01):
    """Single-head fused attention over the v1 layout
    (``gist_tpu/ops/pallas_gat.py:gat_attention_pallas``): z (N, D), the
    per-node score halves (N,) -> (N, D), one K7 launch."""
    if graph.tiled is None:
        raise ValueError("graph carries no v1 layout (build it with "
                         "tiles=True, tile_mode='gather')")
    return _GATTiled.apply(z, src_score, dst_score, graph, negative_slope)
