"""The deterministic segment path (``ops/segment_csr.py``) against the
JAX package's segment ops, on the CPU: S1's plain version and the
Functions built on it, the CSR offsets they read, and the sharded
boundary sums.

Graphs carry duplicate edges, rows without edges, padding edges
(receiver ``n_nodes``) and a padded sink row (a last node without edges,
as a sampler batch pads its nodes).  Bars: the aggregation 1e-6 relative
to the max (both sum the same fp32 terms, in another order on the JAX
side); the GAT composite 1e-5 (exp and the division add their rounding);
the sharded sums 1e-6 against the gather and ``index_add_`` they
replace; ``gradcheck`` in float64 at its own defaults.
"""

import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gist_tpu.graph as JG
from gist_tpu.ops import segment as JS
from gist_tpu.ops.spmm import spmm_segment as jax_segment

import gist_tpu_torch.graph as TG
from gist_tpu_torch.ops import dedup_spmm
from gist_tpu_torch.ops import segment as TS
from gist_tpu_torch.ops import segment_csr as S
from gist_tpu_torch.ops import spmm as TSP
from torch_port_helpers import load_jax_partitioner

SLOPE = 0.01


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _edges(rng, case):
    """(senders, receivers, n, pad_to) of a named small graph."""
    if case == "random":
        n = 90
        s, r = rng.integers(0, n - 1, 600), rng.integers(0, n - 1, 600)
        return s, r, n, 640
    if case == "duplicates":
        # every edge three times, rows 40.. empty, node n - 1 a sink
        n = 70
        s, r = rng.integers(0, 60, 120), rng.integers(0, 40, 120)
        return np.tile(s, 3), np.tile(r, 3), n, 400
    if case == "hub":
        # one receiver with most edges, one sender with most edges
        n = 50
        s = np.concatenate([rng.integers(0, n - 1, 300), np.full(80, 7)])
        r = np.concatenate([np.full(300, 3), rng.integers(0, n - 1, 80)])
        return s, r, n, 384
    raise ValueError(case)


CASES = ("random", "duplicates", "hub")


def _pair(rng, case):
    s, r, n, pad = _edges(rng, case)
    return (JG.graph_from_edges(s, r, n, pad_to=pad),
            TG.graph_from_edges(s, r, n, pad_to=pad), n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# --- the kernel library and its launch plan ------------------------------

def test_library_named_by_its_sources():
    lib = dedup_spmm.library_path(S.SOURCE)
    assert os.path.dirname(lib) == dedup_spmm.BUILD_DIR
    assert re.fullmatch(r"libsegment_csr-[0-9a-f]{12}\.so",
                        os.path.basename(lib))
    assert os.path.join(os.path.dirname(S.SOURCE), "tiled_rows.cuh") in \
        dedup_spmm._sources(S.SOURCE)


@pytest.mark.parametrize("header,renames", [("tiled_rows.cuh", True),
                                            ("count_block.cuh", False)])
def test_header_edit_renames_s1_only_through_its_header(tmp_path, header,
                                                        renames):
    csrc = tmp_path / "csrc"
    shutil.copytree(os.path.dirname(S.SOURCE), csrc)
    source = str(csrc / "segment_csr.cu")
    before = dedup_spmm.library_path(source)
    assert before == dedup_spmm.library_path(S.SOURCE)
    data = bytearray((csrc / header).read_bytes())
    data[-2] ^= 0x20
    (csrc / header).write_bytes(bytes(data))
    assert (dedup_spmm.library_path(source) != before) == renames


@pytest.mark.parametrize("name", ["atomicAdd", "atomicMax", "memset"])
def test_source_has_no_atomics_or_zero_fill(name):
    with open(S.SOURCE, encoding="utf-8") as fh:
        assert name not in fh.read()


# the segment path's shapes (f, item, row alignment, segments): the
# flagship-shaped batch (1,321 padded rows) at F=256 and 100 in fp32 and
# bf16, the GAT weighted sum (H=2, D=256 and 41) and the softmax
# denominators (F = heads = 2) on it, synth-reddit-small (23,000 rows)
# at F=602 and 256
PATH_SHAPES = [(256, 4, 16, 1321), (100, 4, 16, 1321), (256, 2, 16, 1321),
               (100, 2, 8, 1321), (256, 4, 16, 2642), (41, 4, 4, 2642),
               (2, 4, 8, 1321), (602, 4, 8, 23000), (256, 4, 16, 23000)]


@pytest.mark.parametrize("f,item,align,segs,plan,grid", [
    (*PATH_SHAPES[0], (8, 1, 8, 16), 331),
    (*PATH_SHAPES[1], (8, 1, 8, 16), 166),
    (*PATH_SHAPES[2], (8, 1, 8, 16), 166),
    (*PATH_SHAPES[3], (8, 1, 8, 8), 166),
    (*PATH_SHAPES[4], (8, 1, 8, 16), 661),
    (*PATH_SHAPES[5], (16, 1, 4, 16), 166),
    (*PATH_SHAPES[6], (1, 1, 8, 8), 6),
    (*PATH_SHAPES[7], (32, 2, 4, 8, True), 14375),
    (*PATH_SHAPES[8], (8, 1, 8, 16, True), 5750)])
def test_launch_plan(f, item, align, segs, plan, grid):
    """The plans pinned at the segment path's shapes (``PATH_SHAPES``),
    each in the plan space, and its grid: block columns of near-equal
    width, 256 lanes a block; 8-byte vectors on rows aligned to 8 bytes
    only, 16-byte ones (realigned) on rows aligned to less; the units
    of a launch of more than a wave of the card (synth-reddit-small)
    block column by block column."""
    got = S.launch_plan(f, item, align, segs)
    assert got == S.Plan(*plan)
    assert got in S.plan_space(f, item, align)
    assert got.grid(segs, f, item) == grid


@pytest.mark.parametrize("f,item,ptrs,want", [
    (256, 4, (0, 4096), 4), (256, 2, (0, 4096), 8), (602, 4, (0, 256), 2),
    (41, 4, (0, 256), 1), (256, 4, (0, 8), 2), (100, 2, (0, 64), 4)])
def test_vec_width(f, item, ptrs, want):
    assert S.vec_width(f, item, *ptrs) == want


MAP_WIDTHS = (1, 2, 3, 41, 100, 255, 256, 257, 301, 602, 1024)
ITEMS = {"float32": 4, "bfloat16": 2, "float64": 8}


def _maps(f, item):
    """``column_map`` of every plan of the plan space at every row-start
    offset an element of ``item`` bytes can have in a 16-byte word (the
    8-byte plans at the offsets on 8-byte boundaries)."""
    for off in range(0, S.WORD, item):
        align = (off | S.WORD) & -(off | S.WORD)
        for plan in S.plan_space(f, item, align):
            # a row's start: any element of its 16-byte word, after a few
            # whole words (the word index must not matter)
            yield plan, off + 3 * S.WORD, S.column_map(plan, f, item,
                                                       off + 3 * S.WORD)


@pytest.mark.parametrize("dtype", sorted(ITEMS))
@pytest.mark.parametrize("f", MAP_WIDTHS)
def test_column_map_covers_each_column_once(f, dtype):
    """Every plan's lanes hold every column of the row exactly once
    (the stores write each once), whatever the row's start, and every
    load is of a whole aligned word of the plan's width (16 bytes
    wherever the row is not on an 8-byte boundary) that holds a byte of
    the row."""
    item = ITEMS[dtype]
    for plan, off, m in _maps(f, item):
        vb = plan.vec_bytes
        assert vb == S.WORD or off % vb == 0
        cols = m["cols"][m["cols"] >= 0]
        assert torch.equal(cols.sort().values, torch.arange(f)), (plan, off)
        loads = m["load"][m["load"] >= 0]
        assert bool((loads % vb == 0).all()), (plan, off)
        assert bool(((loads < off + f * item)
                     & (loads + vb > off)).all()), (plan, off)
        # the block columns are of near-equal width
        per_y = (m["cols"][..., 0] >= 0).flatten(1).sum(1)
        assert int(per_y.max() - per_y.min()) <= 1, (plan, off)


@pytest.mark.parametrize("dtype", sorted(ITEMS))
@pytest.mark.parametrize("f", MAP_WIDTHS)
def test_column_map_words_hold_each_lanes_columns(f, dtype):
    """A lane's columns are the bytes at ``shift`` .. of its own word
    followed by the word its neighbour loaded (the shuffle), so the byte
    shift puts each column in place: each column's bytes lie where the
    map says, in a word that was loaded."""
    item = ITEMS[dtype]
    for plan, off, m in _maps(f, item):
        vb = plan.vec_bytes
        pos = m["shift"] + torch.arange(max(vb // item, 1)) * item
        own = m["load"][..., :plan.per_lane].unsqueeze(-1)
        nxt = m["next"].unsqueeze(-1)
        first = pos < vb
        src = torch.where(first, own, nxt)
        at = torch.where(first, own + pos, nxt + pos - vb)
        live = m["cols"] >= 0
        assert bool((src[live] >= 0).all()), (plan, off)
        assert torch.equal(at[live], off + m["cols"][live] * item), \
            (plan, off)


@pytest.mark.parametrize("f,item,align", sorted({s[:3] for s in
                                                 PATH_SHAPES}))
def test_plan_space_fills_half_a_block_column(f, item, align):
    """Every plan of the space has an instance and uses at least half
    of its block column's lanes on the path's widths; 8-byte plans only
    on rows aligned to 8 bytes."""
    space = S.plan_space(f, item, align)
    assert {p.vec_bytes for p in space} == ({16, 8} if align == 8
                                           else {16})
    for plan in space:
        nv = S.n_vectors(f, item, plan.vec_bytes)
        assert tuple(plan[:3]) in S.PLANS
        assert 2 * nv >= plan.group * plan.per_lane
        assert nv <= plan.block_cols(f, item) * plan.group * plan.per_lane


@pytest.mark.parametrize("dtype", sorted(ITEMS))
@pytest.mark.parametrize("segs", [1, 1321, 23000])
def test_launch_plan_has_an_instance(dtype, segs):
    """At every width up to 1,100 and every row alignment the dtype
    allows, the launched plan is one the kernel has an instance for and
    one of the plan space that ``s1_plans`` times."""
    item = ITEMS[dtype]
    for f in range(1, 1101):
        for off in range(0, S.WORD, item):
            align = S.row_align(f, item, off)
            plan = S.launch_plan(f, item, align, segs)
            assert tuple(plan[:3]) in S.PLANS, (f, off, plan)
            assert plan in S.plan_space(f, item, align), (f, off, plan)
            assert plan.vec_bytes == S.WORD or align % plan.vec_bytes == 0


@pytest.mark.parametrize("f,item,ptr,want", [
    (602, 4, 0, 8), (256, 4, 0, 16), (100, 2, 0, 8), (2, 4, 0, 8),
    (41, 4, 0, 4), (256, 4, 4, 4), (256, 2, 8, 8), (3, 2, 0, 2),
    (100, 8, 8, 8)])
def test_row_align(f, item, ptr, want):
    """The alignment every row start shares: of the base address and of
    the row's bytes, at most 16."""
    assert S.row_align(f, item, ptr) == want


# --- the plain version ---------------------------------------------------

def test_plain_sums_each_row_in_edge_order(rng):
    """The plain version adds a row's edges one by one in edge order from
    0 (the order S1 keeps), bitwise, whatever the chunking; no launch is
    counted on the CPU."""
    s, r, n, pad = _edges(rng, "hub")
    g = TG.graph_from_edges(s, r, n, pad_to=pad)
    x = torch.from_numpy(rng.standard_normal((n, 5)).astype(np.float32))
    w = torch.from_numpy(rng.random(pad).astype(np.float32))
    before = S.launches
    want = torch.zeros((n, 5))
    ip = g.indptr.tolist()
    for i in range(n):
        for e in range(ip[i], ip[i + 1]):
            want[i] += w[e] * x[int(g.senders[e])]
    for chunk in (None, 7, 1000):
        got = S.segment_csr(g.indptr, x, g.senders, w, edge_chunk=chunk)
        assert torch.equal(got, want)
    assert S.launches == before


def test_plain_bf16_accumulates_in_fp32(rng):
    s, r, n, pad = _edges(rng, "hub")
    g = TG.graph_from_edges(s, r, n, pad_to=pad)
    x = torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32))
    got = S.segment_csr(g.indptr, x.bfloat16(), g.senders)
    want = S.segment_csr(g.indptr, x.bfloat16().float(), g.senders)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


def test_wrapper_refuses_other_devices():
    g = TG.graph_from_edges([0, 1], [1, 0], 2)
    with pytest.raises(ValueError):
        S.segment_csr(g.indptr.to("meta"), torch.zeros((2, 3),
                                                       device="meta"))


# --- the Functions against the JAX package --------------------------------

@pytest.mark.parametrize("case", CASES)
def test_aggregate_matches_jax(rng, case):
    """``spmm_segment`` forward and x-gradient against the JAX segment
    path and its ``jax.vjp``: 1e-6 relative to the max."""
    gj, gt, n = _pair(rng, case)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    ct = rng.standard_normal((n, 12)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax_segment(gj, a), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(ct))
    for fn in (TSP.spmm_segment, TSP.spmm_segment_chunked,
               lambda g, a: TSP.spmm_segment_chunked(g, a, edge_chunk=33)):
        xt = torch.tensor(x, requires_grad=True)
        out = fn(gt, xt)
        (dx,) = torch.autograd.grad(out, [xt], torch.from_numpy(ct))
        assert _rel(out.detach(), want) <= 1e-6
        assert _rel(dx, want_dx) <= 1e-6


def _jax_composite(gj, hs):
    """The JAX side of the GAT composite checks, as one ``jax.vjp`` (one
    compile a case): the attention from node scores, with a zero offset
    ``eps`` on the edge scores whose cotangent is each edge's term of the
    score gradients; the softmax of given edge scores and the weighted
    sum of its alpha; the weighted sum of a given alpha.  Each use of z
    is its own input, so each gradient stays apart."""
    def f(z1, src, dst, eps, z2, sc, z3, al):
        e = (jnp.take(src, gj.senders, axis=0, mode="clip")
             + jnp.take(dst, gj.receivers, axis=0, mode="clip") + eps)
        att = JS.segment_weighted_sum(
            gj, z1, JS.segment_softmax(gj, jax.nn.leaky_relu(e, SLOPE)))
        alpha = JS.segment_softmax(gj, sc)
        return (att, JS.segment_weighted_sum(gj, z2, alpha), alpha,
                JS.segment_weighted_sum(gj, z3, al))
    return f


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("heads", [1, 2])
def test_gat_composite_matches_jax(rng, case, heads):
    """``gat_attention_segment``, ``segment_softmax`` with
    ``segment_weighted_sum`` from given scores, and
    ``segment_weighted_sum`` of a given alpha, against the JAX ops:
    forward and the gradients of z, both scores and alpha, 1e-5."""
    gj, gt, n = _pair(rng, case)
    hs = () if heads == 1 else (heads,)
    e_pad = gj.n_edges_padded
    z = rng.standard_normal((n,) + hs + (8,)).astype(np.float32)
    src = rng.standard_normal((n,) + hs).astype(np.float32)
    dst = rng.standard_normal((n,) + hs).astype(np.float32)
    sc = rng.standard_normal((e_pad,) + hs).astype(np.float32)
    al = rng.random((e_pad,) + hs).astype(np.float32)
    al[np.asarray(gj.receivers) >= n] = 0.0       # alpha is 0 on padding
    ct = rng.standard_normal((n,) + hs + (8,)).astype(np.float32)
    ct_a = rng.standard_normal((e_pad,) + hs).astype(np.float32)
    eps = np.zeros((e_pad,) + hs, np.float32)
    (want, want_h, want_a, want_h3), vjp = jax.vjp(
        _jax_composite(gj, hs),
        *map(jnp.asarray, (z, src, dst, eps, z, sc, z, al)))
    (wz, wsrc, wdst, terms, wz2, wsc, wz3, wal) = map(np.asarray, vjp(
        tuple(map(jnp.asarray, (ct, ct, ct_a, ct)))))

    leaves = [torch.tensor(a, requires_grad=True) for a in (z, src, dst)]
    out = TS.gat_attention_segment(gt, *leaves, SLOPE)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    assert _rel(out.detach(), want) <= 1e-5
    assert _rel(grads[0], wz) <= 1e-5
    # a score's gradient sums its edges' terms, which cancel (the softmax
    # does not move when a receiver's scores all move): held relative to
    # the largest sum of their magnitudes, the scale of its rounding
    for got, wg, by in zip(grads[1:], (wsrc, wdst), ("senders", "receivers")):
        scale = _sum_by(gj, np.abs(terms), by, n)
        assert _rel_to(got, wg, scale) <= 1e-5

    zt = torch.tensor(z, requires_grad=True)
    st = torch.tensor(sc, requires_grad=True)
    alpha = TS.segment_softmax(gt, st)
    h = TS.segment_weighted_sum(gt, zt, alpha, edge_chunk=100)
    gz, gsc = torch.autograd.grad((h, alpha), (zt, st),
                                  (torch.from_numpy(ct),
                                   torch.from_numpy(ct_a)))
    assert _rel(alpha.detach(), want_a) <= 1e-5
    assert _rel(h.detach(), want_h) <= 1e-5
    assert _rel(gz, wz2) <= 1e-5
    assert _rel(gsc, wsc) <= 1e-5

    zt = torch.tensor(z, requires_grad=True)
    at = torch.tensor(al, requires_grad=True)
    h3 = TS.segment_weighted_sum(gt, zt, at)
    gz3, ga3 = torch.autograd.grad(h3, (zt, at), torch.from_numpy(ct))
    assert _rel(h3.detach(), want_h3) <= 1e-5
    assert _rel(gz3, wz3) <= 1e-5
    assert _rel(ga3, wal) <= 1e-5


def _sum_by(gj, a, by, n):
    """``a``'s real edges summed by sender or by receiver."""
    r = np.asarray(gj.receivers)
    keys = np.asarray(gj.senders if by == "senders" else gj.receivers)
    out = np.zeros((n,) + a.shape[1:])
    np.add.at(out, keys[r < n], a[r < n])
    return out


def _rel_to(got, want, scale):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()
                 / max(np.abs(scale).max(), np.abs(want).max(), 1e-30))


def _double_graph(rng):
    s, r, n, pad = _edges(rng, "duplicates")
    return TG.graph_from_edges(s, r, n, pad_to=pad), n


GRADCHECK = ("aggregate", "sum_rows", "gather_receivers", "gather_senders",
             "gather_unsorted", "weighted_sum_h1", "weighted_sum_h2")


@pytest.mark.parametrize("fn", GRADCHECK)
def test_gradcheck(rng, fn):
    """Each Function's backward against finite differences, float64."""
    g, n = _double_graph(rng)
    e = g.n_edges_padded
    valid = (g.receivers < n).double()

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape)) \
            .requires_grad_(True)

    if fn == "aggregate":
        args, f = (leaf(n, 3),), lambda x: S.aggregate(g, x)
    elif fn == "sum_rows":
        # padding edges' rows are masked, as the softmax masks them
        args = (leaf(e, 2),)

        def f(m):
            return S.sum_rows(m * valid[:, None], g.indptr, g.receivers)
    elif fn == "gather_receivers":
        args, f = (leaf(n, 2),), lambda y: S.gather_receivers(g, y) \
            * valid[:, None]
    elif fn == "gather_senders":
        args, f = (leaf(n, 2),), lambda y: S.gather_senders(g, y) \
            * valid[:, None]
    elif fn == "gather_unsorted":
        idx = torch.from_numpy(rng.integers(0, n + 3, 50)).int()
        args, f = (leaf(n, 2),), lambda y: S.gather(y, idx) \
            * (idx < n).double()[:, None]
    else:
        h = 1 if fn.endswith("h1") else 2
        z = leaf(n, 4) if h == 1 else leaf(n, h, 4)
        a = torch.from_numpy(rng.random((e,) if h == 1 else (e, h))
                             * (valid if h == 1 else valid[:, None]).numpy())
        args = (z, a.requires_grad_(True))

        def f(z, a):
            return S.weighted_sum(g, z, a)
    assert torch.autograd.gradcheck(f, args)


def test_gather_backward_leaves_padding_out(rng):
    """Padding edges read the last row (``mode="clip"``) and add nothing
    to its gradient; real edges each add theirs once."""
    g, n = _double_graph(rng)
    y = torch.zeros((n, 1), requires_grad=True)
    out = S.gather_receivers(g, y)
    (dy,) = torch.autograd.grad(out, [y], torch.ones_like(out))
    assert torch.equal(dy[:, 0], g.in_degrees)
    out = S.gather_senders(g, y)
    (dy,) = torch.autograd.grad(out, [y], torch.ones_like(out))
    assert torch.equal(dy[:, 0], g.out_degrees)


# --- the CSR offsets the Functions read --------------------------------------

def _check_csr(g):
    n, e_pad = g.n_nodes, g.n_edges_padded
    r, tr = g.receivers.long(), g.t_receivers.long()
    valid = int((r < n).sum())
    for ptr, keys in ((g.indptr, r), (g.t_indptr, tr)):
        assert ptr.dtype == torch.int32 and ptr.shape == (n + 1,)
        assert int(ptr[0]) == 0 and int(ptr[-1]) == valid
        counts = torch.bincount(keys[keys < n], minlength=n)
        assert torch.equal((ptr[1:] - ptr[:-1]).long(), counts)
        assert bool((keys[valid:] == n).all())
    perm = g.t_perm.long()
    assert g.t_perm.dtype == torch.int32 and perm.shape == (e_pad,)
    assert torch.equal(torch.sort(perm).values, torch.arange(e_pad))
    want = torch.sort(torch.where(r < n, g.senders.long(), n),
                      stable=True).indices
    assert torch.equal(perm, want)                 # stable
    assert torch.equal(g.senders.long()[perm[:valid]], tr[:valid])
    assert torch.equal(r[perm[:valid]], g.t_senders.long()[:valid])
    assert torch.equal(S.sender_perm(g.replace(t_perm=None)), g.t_perm)


@pytest.mark.parametrize("case", CASES)
def test_graph_csr_and_sender_order(rng, case):
    _, gt, _ = _pair(rng, case)
    _check_csr(gt)
    assert gt.transpose().t_perm is None
    assert torch.equal(gt.to("cpu").t_perm, gt.t_perm)


def test_sampler_batches_carry_the_csr():
    """Batches of the sampler, in both forms and stacked for a capture
    (whose ``n_edges`` is the padded count), carry offsets and a sender
    order that agree with their edges."""
    from gist_tpu_torch.data.synthetic import synthetic_dataset
    from gist_tpu_torch.sampler import ClusterSampler, stack_batches
    ds = synthetic_dataset("synth-cora")
    sampler = ClusterSampler(ds, 8, 2, seed=3, tiles=False)
    for b in sampler:
        _check_csr(b.graph)
    ids = [sampler.make_batch(i, node_pad=3000, edge_pad=12000,
                              ids_only=True)
           for i in list(sampler._epoch_ids())]
    stacked = stack_batches(ids)
    assert stacked.tensors["t_perm"].shape == (len(ids), 12000)
    for (g, _), b in zip(stacked.views(), ids):
        assert g.n_edges == g.n_edges_padded
        assert torch.equal(g.t_perm, b.graph.t_perm)
        _check_csr(g)


def _sharded(rng, d=2):
    from gist_tpu_torch.parallel.graph_shard import build_sharded_graph
    n = 80
    s = np.concatenate([rng.integers(0, n, 500), np.full(20, 5)])
    r = np.concatenate([rng.integers(0, n, 500), np.full(20, 9)])
    parts = [np.arange(0, n, 2), np.arange(1, n, 2)] if d == 2 else None
    return build_sharded_graph(s, r, n, d, parts=parts,
                               interior_tiles=False)


def _check_edge_csr(c, s, r, n_rows, n_src):
    s, r = s.long(), r.long()
    valid = int((r < n_rows).sum())
    assert torch.equal(c.senders.long(), s)
    assert torch.equal((c.indptr[1:] - c.indptr[:-1]).long(),
                       torch.bincount(r[r < n_rows], minlength=n_rows))
    assert int(c.indptr[-1]) == valid == int(c.t_indptr[-1])
    assert torch.equal((c.t_indptr[1:] - c.t_indptr[:-1]).long(),
                       torch.bincount(s[:valid], minlength=n_src))
    perm = c.t_perm.long()[:valid]
    assert torch.equal(perm, torch.sort(s[:valid], stable=True).indices)
    assert torch.equal(c.t_receivers.long()[:valid], r[perm])


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_bundles_carry_the_csr(rng, rank):
    from gist_tpu_torch.parallel.graph_shard import (halo_rows,
                                                     ring_device_arrays)
    sg = _sharded(rng)
    dev = ring_device_arrays(sg, rank, "cpu")
    _check_edge_csr(dev["int_csr"], dev["int_s"], dev["int_r"],
                    sg.n_loc_pad, sg.n_loc_pad)
    _check_edge_csr(dev["bnd_csr"], dev["bnd_s"], dev["bnd_r"],
                    sg.n_loc_pad, halo_rows(sg))
    sent = torch.cat([a for a in dev["ring_send"]])
    p, perm = dev["send_csr"]
    assert torch.equal((p[1:] - p[:-1]).long(),
                       torch.bincount(sent, minlength=sg.n_loc_pad))
    assert torch.equal(perm.long(), torch.sort(sent, stable=True).indices)


# --- the sharded sums against the gather and index_add_ they replace -------

@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_boundary_sums_match_index_add(rng, rank):
    """The boundary sum and its transpose, the interior sums and the
    scatter of the returned halo cotangents, through S1's plain version
    against gather and ``index_add_``: 1e-6."""
    from gist_tpu_torch.parallel import graph_shard as GS
    sg = _sharded(rng)
    dev = GS.ring_device_arrays(sg, rank, "cpu")
    n, hr = sg.n_loc_pad, GS.halo_rows(sg)
    halo = torch.from_numpy(rng.standard_normal((hr, 7)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, 7)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n, 7)).astype(np.float32))

    def index_add(rows, src, idx, dst, padded):
        out = torch.zeros((rows + 1, 7))
        if padded:
            src = torch.cat([src, torch.zeros((1, 7))])
        return out.index_add_(0, dst, src.index_select(0, idx))[:rows]

    bnd, ic = dev["bnd_csr"], dev["int_csr"]
    bs, br = dev["bnd_s"], dev["bnd_r"]
    got = S.segment_csr(bnd.indptr, halo, bnd.senders)
    assert _rel(got, index_add(n, halo, bs, br, False)) <= 1e-6
    got = S.segment_csr(bnd.t_indptr, g, bnd.t_receivers)
    want = torch.zeros((hr, 7)).index_add_(
        0, bs, torch.cat([g, torch.zeros((1, 7))]).index_select(0, br))
    assert _rel(got, want) <= 1e-6
    got = GS._interior(sg, dev, x)
    assert _rel(got, index_add(n, x, dev["int_s"], dev["int_r"], False)) \
        <= 1e-6
    got = GS._interior(sg, dev, g, transpose=True)
    assert _rel(got, index_add(n, g, dev["int_r"], dev["int_s"], True)) \
        <= 1e-6
    received = [torch.from_numpy(rng.standard_normal(
        (a.shape[0], 7)).astype(np.float32)) for a in dev["ring_send"]]
    got = GS._scatter_back(x.clone(), dev, received)
    want = x.clone()
    for idx, blk in zip(dev["ring_send"], received):
        want.index_add_(0, idx, blk)
    assert _rel(got, want) <= 1e-6
    r = dev["bnd_r"]
    m = torch.from_numpy(rng.standard_normal((r.shape[0], 2))
                         .astype(np.float32))
    want = torch.zeros((n + 1, 2)).index_add_(0, r, m)[:n]
    assert _rel(GS._segment_sum(m, r, n), want) <= 1e-6
    assert _rel(GS._segment_sum(m, r, n, bnd.indptr), want) <= 1e-6
