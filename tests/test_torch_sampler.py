"""The port's Cluster-GCN sampler against the JAX package: one seed
must give the same node-id streams, batches, dedup layouts and round
padding."""

import numpy as np
import pytest

from gist_tpu.data.container import Dataset as JDataset
from gist_tpu.data.synthetic import synthetic_dataset
from gist_tpu.sampler import ClusterSampler as JSampler
from gist_tpu.sampler import unify_tile_buckets as j_unify
from gist_tpu.train.ist_cluster import _RoundCollector as JCollector

from gist_tpu_torch.data.container import Dataset as TDataset
from gist_tpu_torch.sampler import ClusterSampler as TSampler
from gist_tpu_torch.sampler import bucket_size
from gist_tpu_torch.sampler import unify_tile_buckets as t_unify
from gist_tpu_torch.train.ist_cluster import _RoundCollector as TCollector
from torch_port_helpers import load_jax_partitioner


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


GRAPH_FIELDS = ("senders", "receivers", "indptr", "in_degrees",
                "out_degrees", "t_senders", "t_receivers", "t_indptr")


@pytest.fixture(scope="module")
def datasets():
    """synth-cora with most nodes in the train set, so cluster batches
    span several destination tiles."""
    ds = synthetic_dataset("synth-cora")
    train = np.random.default_rng(5).random(ds.n_nodes) < 0.9
    arrays = dict(name=ds.name, senders=ds.senders, receivers=ds.receivers,
                  features=ds.features, labels=ds.labels, train_mask=train,
                  val_mask=~train, test_mask=~train, n_classes=ds.n_classes)
    return JDataset(**arrays), TDataset(**arrays)


def _samplers(datasets, tiles, psize=8, batch_size=2, seed=3):
    jd, td = datasets
    return (JSampler(jd, psize, batch_size, seed=seed, tiles=tiles),
            TSampler(td, psize, batch_size, seed=seed, tiles=tiles))


def _eq(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if hasattr(b, "numpy") else np.asarray(b)
    assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _assert_layouts_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert (a.tile_rows, a.cu, a.max_jobs) == (b.tile_rows, b.cu, b.max_jobs)
    for f in ("u_senders", "w_blocks", "job_offsets"):
        _eq(getattr(a, f), getattr(b, f), f)
    assert a.pos is None and b.pos is None


def _assert_batches_equal(a, b):
    assert (a.n_real_nodes, a.n_real_edges) == (b.n_real_nodes,
                                                b.n_real_edges)
    assert (a.graph.n_nodes, a.graph.n_edges) == (b.graph.n_nodes,
                                                  b.graph.n_edges)
    for f in GRAPH_FIELDS:
        _eq(getattr(a.graph, f), getattr(b.graph, f), f)
    _assert_layouts_equal(a.graph.dedup, b.graph.dedup)
    _assert_layouts_equal(a.graph.dedup_t, b.graph.dedup_t)
    for f in ("features", "labels", "train_mask", "node_ids"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            _eq(x, y, f)


def test_bucket_size_matches():
    from gist_tpu.sampler import bucket_size as jb
    for n in (1, 255, 256, 257, 1000, 123456):
        assert bucket_size(n) == jb(n)
        assert bucket_size(n, 1.2, 8) == jb(n, 1.2, 8)


def test_node_id_streams_two_epochs(datasets):
    js, ts = _samplers(datasets, tiles=False)
    assert len(js) == len(ts) == 4
    for p, q in zip(js.partitions, ts.partitions):
        np.testing.assert_array_equal(p, q)
    jit, tit = js.iter_node_ids(), ts.iter_node_ids()
    for _ in range(2 * len(js)):
        np.testing.assert_array_equal(next(jit), next(tit))


def test_batches_with_tiles_identical(datasets):
    js, ts = _samplers(datasets, tiles=True)
    n_tiled = 0
    for a, b in zip(js, ts):
        _assert_batches_equal(a, b)
        n_tiled += b.graph.dedup is not None
        ids = np.asarray(np.nonzero(np.asarray(a.train_mask))[0])
        assert len(ids) == a.n_real_nodes
    assert n_tiled == len(ts)
    assert max(b.graph.dedup.num_tiles for b in ts) > 1


def test_ids_form_and_tables(datasets):
    js, ts = _samplers(datasets, tiles=False)
    ids = next(js.iter_node_ids())
    next(ts.iter_node_ids())
    a, b = js.make_batch(ids, ids_only=True), ts.make_batch(ids, ids_only=True)
    _assert_batches_equal(a, b)
    for x, y in zip(js.tables(), ts.tables()):
        _eq(x, y, "tables")
    g, f, lab, m = TSampler.resolve_batch(b, ts.tables())
    _eq(np.asarray(js.tables()[0])[np.asarray(a.node_ids)], f, "gather")


def test_round_collector_pads_identical(datasets):
    js, ts = _samplers(datasets, tiles=True)
    jc, tc = JCollector(js, 3, ids_only=True), TCollector(ts, 3,
                                                          ids_only=True)
    for _ in range(3):   # rounds straddle epoch boundaries
        ja, ta = jc.collect(), tc.collect()
        assert len({b.graph.n_nodes for b in ta}) == 1   # shared node pad
        assert len({b.graph.n_edges_padded for b in ta}) == 1
        for a, b in zip(ja, ta):
            _assert_batches_equal(a, b)
        for a, b in zip(j_unify(ja), t_unify(ta)):
            _assert_layouts_equal(a.graph.dedup, b.graph.dedup)
            _assert_layouts_equal(a.graph.dedup_t, b.graph.dedup_t)


def test_use_pp_features_identical(datasets):
    """``use_pp``: ``[X || (A X) / deg]`` over the train subgraph, equal
    arrays in the sampler, its batches and its tables."""
    jd, td = datasets
    js = JSampler(jd, 8, 2, seed=3, tiles=False, use_pp=True)
    ts = TSampler(td, 8, 2, seed=3, tiles=False, use_pp=True)
    assert ts.features.shape[1] == 2 * td.in_feats
    _eq(js.features, ts.features, "use_pp features")
    for a, b in zip(js, ts):
        _assert_batches_equal(a, b)
    for x, y in zip(js.tables(), ts.tables()):
        _eq(x, y, "tables")


def test_multi_hot_labels_identical(datasets):
    """Multitask datasets: (N, C) float32 labels in batches (zero rows
    on padding) and tables, equal to the JAX sampler's."""
    from dataclasses import replace
    jd, td = datasets
    w = np.random.default_rng(1).standard_normal((jd.in_feats, 5))
    multi = (jd.features @ w > 0).astype(np.float32)
    jd, td = replace(jd, labels_multi=multi), replace(td, labels_multi=multi)
    js, ts = _samplers((jd, td), tiles=False)
    assert ts.labels.shape == (ts.n_nodes, 5)
    n = 0
    for a, b in zip(js, ts):
        _assert_batches_equal(a, b)
        assert b.labels.shape == (b.graph.n_nodes, 5)
        assert not b.labels[b.n_real_nodes:].any()
        n += 1
    assert n == len(ts)
    ids = next(ts.iter_node_ids())
    _assert_batches_equal(js.make_batch(ids, ids_only=True),
                          ts.make_batch(ids, ids_only=True))
    for x, y in zip(js.tables(), ts.tables()):
        _eq(x, y, "tables")
