"""The v1 gather layout (``TiledCSR``) and K3's plain version against the
JAX package.

Host builders (``_build_tiled_csr``, ``_link_tiled_pair``,
``pad_tiled_csr``, ``with_tiles`` with its fall-throughs into the v1
layout, ``graph_from_edges``, the sampler's ``tile_mode="gather"`` and
``unify_tile_buckets``) must give equal arrays.  K3's plain walk is held
against the Pallas kernel in interpret mode at 1e-4 (the JAX tests' bar:
the interpret kernel splits fp32 into hi/lo bf16) and against the
segment path at 1e-5; ``gcn.apply`` and ``train_full_graph`` on a v1
graph against the JAX segment path as in ``test_torch_gcn.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gist_tpu.graph as JG
from conftest import make_random_graph
from gist_tpu.data.container import Dataset as JDataset
from gist_tpu.data.synthetic import synthetic_dataset
from gist_tpu.models import gcn as jgcn
from gist_tpu.ops import pallas_spmm as JPS
from gist_tpu.sampler import ClusterSampler as JSampler
from gist_tpu.sampler import unify_tile_buckets as j_unify
from gist_tpu.train.common import TrainConfig as JTrainConfig
from gist_tpu.train.full_graph import train_full_graph as jax_train

import gist_tpu_torch.graph as TG
from gist_tpu_torch.convert import params_from_jax
from gist_tpu_torch.data.container import Dataset
from gist_tpu_torch.models import gcn as tgcn
from gist_tpu_torch.ops import spmm as TS
from gist_tpu_torch.ops import tiled_spmm as K3
from gist_tpu_torch.sampler import ClusterSampler as TSampler
from gist_tpu_torch.sampler import unify_tile_buckets as t_unify
from gist_tpu_torch.train.common import TrainConfig
from gist_tpu_torch.train.full_graph import train_full_graph
from torch_port_helpers import load_jax_partitioner, run_interpret

TILED_FIELDS = ("senders", "receivers", "tile_offsets", "pos_in_other")


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tiled_equal(a, b):
    """A JAX TiledCSR and the port's: every array equal, int32, and the
    static fields equal."""
    assert (a is None) == (b is None)
    if a is None:
        return
    assert (a.tile_rows, a.chunk, a.max_chunks) == (b.tile_rows, b.chunk,
                                                    b.max_chunks)
    for f in TILED_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert y.dtype == torch.int32, f
            np.testing.assert_array_equal(np.asarray(x), y.numpy(),
                                          err_msg=f)


def _edges(case, rng):
    """(senders, receivers, n) of a named graph."""
    if case == "random":
        return (*make_random_graph(rng, 300, 1500), 300)
    if case == "multi_chunk":
        # tile 0's receivers carry > 1024 edges: several chunks
        r = np.repeat(np.arange(128), 12)
        s = rng.integers(0, 500, len(r))
        return (np.concatenate([s, rng.integers(0, 500, 600)]),
                np.concatenate([r, rng.integers(0, 500, 600)]), 500)
    if case == "empty":
        # receivers below 100 of 333 nodes: isolated nodes, empty
        # trailing tiles, n not a multiple of 128
        return rng.integers(0, 333, 700), rng.integers(0, 100, 700), 333
    if case == "parallel":
        # one (tile, sender) pair repeated 128 times: an int8 count
        # overflows, so the dedup builds fail
        s = np.concatenate([np.full(128, 5), rng.integers(0, 300, 400)])
        r = np.concatenate([np.full(128, 7), rng.integers(0, 300, 400)])
        return s, r, 300
    raise ValueError(case)


CASES = ["random", "multi_chunk", "empty", "parallel"]


# --- builders ---------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("tile_rows", [128, 64])
def test_build_tiled_csr_and_link_equal(rng, case, tile_rows):
    s, r, n = _edges(case, rng)
    gj, gt = JG.graph_from_edges(s, r, n), TG.graph_from_edges(s, r, n)
    e = gt.n_edges
    sj = np.asarray(gj.senders[:e])
    a, a_dst = JG._build_tiled_csr(sj, np.asarray(gj.receivers[:e]),
                                   np.asarray(gj.indptr, np.int64), n,
                                   tile_rows=tile_rows)
    b, b_dst = TG._build_tiled_csr(gt.senders[:e].numpy(),
                                   gt.receivers[:e].numpy(),
                                   gt.indptr.numpy(), n, tile_rows=tile_rows)
    _assert_tiled_equal(a, b)
    np.testing.assert_array_equal(a_dst, b_dst)
    at, at_dst = JG._build_tiled_csr(
        np.asarray(gj.t_senders[:e]), np.asarray(gj.t_receivers[:e]),
        np.asarray(gj.t_indptr, np.int64), n, tile_rows=tile_rows)
    bt, bt_dst = TG._build_tiled_csr(
        gt.t_senders[:e].numpy(), gt.t_receivers[:e].numpy(),
        gt.t_indptr.numpy(), n, tile_rows=tile_rows)
    order = np.argsort(sj, kind="stable")
    for x, y in zip(JG._link_tiled_pair(a, a_dst, at, at_dst, order, e),
                    TG._link_tiled_pair(b, b_dst, bt, bt_dst, order, e)):
        _assert_tiled_equal(x, y)
    # each row's slots are one contiguous, receiver-sorted range
    b = TG._build_tiled_pair(gt, tile_rows)[0]
    offs = b.tile_offsets.numpy()
    for i in range(b.num_tiles):
        seg = b.receivers.numpy()[offs[i]:offs[i + 1]]
        assert np.all(np.diff(seg) >= 0)


@pytest.mark.parametrize("case", ["random", "empty"])
def test_pad_tiled_csr_equal(rng, case):
    s, r, n = _edges(case, rng)
    a = JG.graph_from_edges(s, r, n, tiles=True, tile_mode="gather")
    b = TG.graph_from_edges(s, r, n, tiles=True, tile_mode="gather")
    for e_to, mc in ((0, 0), (a.tiled.senders.shape[0] + 5, 7)):
        pa = JG.pad_tiled_csr(a.tiled, e_to, mc)
        pb = TG.pad_tiled_csr(b.tiled, e_to, mc)
        _assert_tiled_equal(pa, pb)
        assert pb.senders.shape[0] % 1024 == 0
        assert torch.all(pb.receivers[b.tiled.senders.shape[0]:]
                         == b.tiled.num_tiles * 128)


def test_with_tiles_gather_roundtrip(rng):
    """``test_graph_ops.py:test_with_tiles_roundtrip``'s cases: lazy and
    eager builds agree, a second call is a no-op, and a graph may carry
    the dedup pair and the v1 pair at once."""
    s, r, n = _edges("random", rng)
    gj, gt = JG.graph_from_edges(s, r, n), TG.graph_from_edges(s, r, n)
    assert gt.tiled is None and gt.dedup is None
    a, b = gj.with_tiles(mode="gather"), gt.with_tiles(mode="gather")
    _assert_tiled_equal(a.tiled, b.tiled)
    _assert_tiled_equal(a.tiled_t, b.tiled_t)
    _assert_tiled_equal(a.transpose().tiled, b.transpose().tiled)
    eager = TG.graph_from_edges(s, r, n, tiles=True, tile_mode="gather")
    _assert_tiled_equal(b.tiled, eager.tiled)
    assert b.with_tiles(mode="gather") is b
    assert b.dedup is None
    both_j = gj.with_tiles().with_tiles(mode="gather")
    both = gt.with_tiles().with_tiles(mode="gather")
    assert both.dedup is not None and both.tiled is not None
    _assert_tiled_equal(both_j.tiled, both.tiled)
    moved = both.to("cpu")
    assert moved.tiled.senders.data_ptr() == both.tiled.senders.data_ptr()
    small = TG.graph_from_edges(s, r, n, tiles=True, tile_rows=64,
                                tile_mode="gather")
    _assert_tiled_equal(JG.graph_from_edges(s, r, n, tiles=True,
                                            tile_rows=64,
                                            tile_mode="gather").tiled,
                        small.tiled)


def test_failed_dedup_falls_back_to_v1(rng, monkeypatch):
    """Where the flat dedup build fails (an int8 count overflow) the JAX
    package falls to the v1 pair, and so must the port; above a lowered
    ``HUGE_EDGES`` a failed chunked build does the same (the JAX side:
    ``mode="dedup-chunked"``, whose failure also goes to v1)."""
    s, r, n = _edges("parallel", rng)
    a = JG.graph_from_edges(s, r, n).with_tiles()
    b = TG.graph_from_edges(s, r, n).with_tiles()
    assert a.dedup is None and b.dedup is None and b.dedup_c is None
    _assert_tiled_equal(a.tiled, b.tiled)
    _assert_tiled_equal(a.tiled_t, b.tiled_t)
    monkeypatch.setattr(TG, "HUGE_EDGES", 100)
    a = JG.graph_from_edges(s, r, n).with_tiles(mode="dedup-chunked")
    b = TG.graph_from_edges(s, r, n, tiles=True)
    assert b.dedup is None and b.dedup_c is None
    _assert_tiled_equal(a.tiled, b.tiled)
    _assert_tiled_equal(a.tiled_t, b.tiled_t)


# --- the sampler's v1 mode ----------------------------------------------------


@pytest.fixture(scope="module")
def cora():
    ds = synthetic_dataset("synth-cora")
    train = np.random.default_rng(5).random(ds.n_nodes) < 0.9
    arrays = dict(name=ds.name, senders=ds.senders, receivers=ds.receivers,
                  features=ds.features, labels=ds.labels, train_mask=train,
                  val_mask=~train, test_mask=~train, n_classes=ds.n_classes)
    return JDataset(**arrays), Dataset(**arrays)


def test_sampler_gather_mode_and_unify(cora):
    """``test_sampler.py:test_sampler_gather_tile_mode_for_gat``'s cases:
    every batch carries the linked, bucketed v1 pair, equal to JAX's; a
    forced slot-bucket mismatch unifies to the same arrays."""
    jd, td = cora
    js = JSampler(jd, 8, 2, seed=3, tiles=True, tile_mode="gather")
    ts = TSampler(td, 8, 2, seed=3, tiles=True, tile_mode="gather")
    batches = []
    for a, b in zip(js, ts):
        assert b.graph.dedup is None and b.graph.tiled.pos_in_other is not None
        assert b.graph.tiled.senders.shape[0] % 1024 == 0
        _assert_tiled_equal(a.graph.tiled, b.graph.tiled)
        _assert_tiled_equal(a.graph.tiled_t, b.graph.tiled_t)
        batches.append((a, b))
    assert max(b.graph.tiled.num_tiles for _, b in batches) > 1
    (a1, b1), (a2, b2) = batches[:2]
    a2 = a2.replace(graph=a2.graph.replace(tiled=JG.pad_tiled_csr(
        a2.graph.tiled, a2.graph.tiled.senders.shape[0] + 1024, 9)))
    b2 = b2.replace(graph=b2.graph.replace(tiled=TG.pad_tiled_csr(
        b2.graph.tiled, b2.graph.tiled.senders.shape[0] + 1024, 9)))
    ju, tu = j_unify([a1, a2]), t_unify([b1, b2])
    for a, b in zip(ju, tu):
        _assert_tiled_equal(a.graph.tiled, b.graph.tiled)
        _assert_tiled_equal(a.graph.tiled_t, b.graph.tiled_t)
    assert tu[0].graph.tiled.senders.shape == tu[1].graph.tiled.senders.shape
    assert tu[0].graph.tiled.max_chunks == 9
    # a batch without the v1 pair turns it off for the round
    off = t_unify([b1, b2.replace(graph=b2.graph.replace(tiled_t=None))])
    assert all(b.graph.tiled is None for b in off)
    assert tu[0].to("cpu").graph.tiled.senders.shape == \
        tu[0].graph.tiled.senders.shape
    with pytest.raises(ValueError):
        TSampler(td, 8, 2, tile_mode="tiled")


# --- K3's plain version -------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("f", [8, 32])
def test_plain_k3_matches_interpret_and_segment(rng, case, f):
    """Forward on ``tiled`` and transpose on ``tiled_t``, with a padded
    layout (slots past ``tile_offsets[-1]``, larger ``max_chunks``)."""
    s, r, n = _edges(case, rng)
    gj = JG.graph_from_edges(s, r, n, tiles=True, tile_mode="gather")
    gt = TG.graph_from_edges(s, r, n, tiles=True, tile_mode="gather")
    x = rng.standard_normal((n, f)).astype(np.float32)
    xt = torch.from_numpy(x)
    for direction in ("fwd", "bwd"):
        g = gt if direction == "fwd" else gt.transpose()
        t = TG.pad_tiled_csr(g.tiled, g.tiled.senders.shape[0] + 2048,
                             g.tiled.max_chunks + 2)
        before = K3.launches
        got = K3.run_tiled(t, xt, n).numpy()
        plain = K3.tiled_spmm(t, xt)
        assert K3.launches == before
        assert plain.shape == (t.num_tiles * 128, f)
        seg = TS.spmm_segment(g, xt).numpy()
        np.testing.assert_allclose(got, seg, rtol=1e-5, atol=1e-5)
        jt = gj.tiled if direction == "fwd" else gj.tiled_t
        want = run_interpret(lambda: JPS._run_tiled(jt, jnp.asarray(x), n))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        if case == "empty" and direction == "fwd":
            assert np.all(plain.numpy()[100:] == 0)


def test_aggregate_v1_grad_and_missing_transpose(rng):
    """``aggregate`` on a v1 graph with the kernel backend: K3's plain
    walk forward and, through ``tiled_t``, backward, against the segment
    path; without ``tiled_t`` the backward raises, as JAX's does."""
    s, r, n = _edges("empty", rng)
    g = TG.graph_from_edges(s, r, n, tiles=True, tile_mode="gather")
    x0 = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    x = x0.clone().requires_grad_(True)
    out = TS.aggregate(g, x, backend="dedup")
    (out * w).sum().backward()
    xs = x0.clone().requires_grad_(True)
    (TS.spmm_segment(g, xs) * w).sum().backward()
    torch.testing.assert_close(out, TS.spmm_segment(g, x0), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(x.grad, xs.grad, rtol=1e-5, atol=1e-5)
    assert TS.resolve_backend(g) == "segment"        # CPU: auto is segment
    fwd_only = g.replace(tiled_t=None)
    TS.aggregate(fwd_only, x0, backend="dedup")
    with pytest.raises(NotImplementedError):
        TS.aggregate(fwd_only, x0.clone().requires_grad_(True),
                     backend="dedup").sum().backward()


def test_gcn_apply_on_v1_matches_jax(rng):
    """Forward and every parameter gradient: the JAX segment path vs K3's
    plain walk on the v1 layout."""
    n = 1200
    s, r = make_random_graph(rng, n, 6000)
    gj = JG.graph_from_edges(s, r, n)
    gt = TG.graph_from_edges(s, r, n, tiles=True, tile_mode="gather")
    cfg = jgcn.GCNConfig(20, 24, 6, n_layers=2, dropout=0.0)
    jp = jgcn.init(jax.random.PRNGKey(3), cfg)
    x = rng.standard_normal((n, 20)).astype(np.float32)
    cot = rng.standard_normal((n, 6)).astype(np.float32)

    def jloss(p):
        logits = jgcn.apply(p, gj, jnp.asarray(x), cfg, backend="segment")
        return jnp.sum(logits * cot), logits

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = params_from_jax(_np_tree(jp))
    leaves = [t.requires_grad_(True)
              for l in tp["layers"] for t in l.values()]
    before = K3.launches
    got = tgcn.apply(tp, gt, torch.from_numpy(x), cfg, train=True,
                     backend="dedup")
    (got * torch.from_numpy(cot)).sum().backward()
    assert K3.launches == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    jleaves = [np.asarray(v) for l in jgrads["layers"] for v in l.values()]
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-4, atol=1e-4)


def test_train_full_graph_gcn_on_v1_matches_jax(rng):
    """GCN through ``train_full_graph`` on a v1 graph (K3's plain walk)
    against the JAX trainer on the segment path, from the JAX initial
    parameters, dropout 0."""
    n, f, c = 1500, 16, 5
    s, r = make_random_graph(rng, n, 7000)
    feats = rng.standard_normal((n, f)).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    split = rng.random(n)
    masks = (split < 0.5, (split >= 0.5) & (split < 0.75), split >= 0.75)
    jds, tds = [cls("tiny-rand", s, r, feats.copy(), labels.copy(), *masks, c)
                for cls in (JDataset, Dataset)]
    cfg = jgcn.GCNConfig(f, 24, c, n_layers=1, dropout=0.0)
    kw = dict(lr=1e-2, weight_decay=5e-4, n_epochs=8, lr_schedule=True)
    want = jax_train(jds, cfg, JTrainConfig(**kw), verbose=False)
    init = _np_tree(jgcn.init(jax.random.PRNGKey(0), cfg))
    graph = TG.graph_from_edges(s, r, n, tiles=True, tile_mode="gather")
    TS.set_default_backend("dedup")
    try:
        got = train_full_graph(tds, tgcn.GCNConfig(f, 24, c, n_layers=1,
                                                   dropout=0.0),
                               TrainConfig(**kw), init_params=init,
                               graph=graph, device="cpu", verbose=False)
    finally:
        TS.set_default_backend("auto")
    n_val = int(tds.val_mask.sum())
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    for k in ("val_accs", "test_accs"):
        np.testing.assert_allclose(got[k], want[k], atol=1.0 / n_val + 1e-7)
    assert got["losses"][-1] < got["losses"][0]
