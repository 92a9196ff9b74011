"""The port's host-side data path against the JAX package: datasets,
partitions, graphs and dedup layouts must be array-equal."""

import numpy as np
import pytest

import gist_tpu.graph as JG
from gist_tpu.data.synthetic import synthetic_dataset as jax_synth
from gist_tpu.partition import get_partition_list as jax_parts

import gist_tpu_torch.graph as TG
from gist_tpu_torch.data import load_dataset
from gist_tpu_torch.data.synthetic import synthetic_dataset as torch_synth
from gist_tpu_torch.partition import get_partition_list as torch_parts
from torch_port_helpers import load_jax_partitioner


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


DS_FIELDS = ("senders", "receivers", "features", "labels", "train_mask",
             "val_mask", "test_mask")


@pytest.fixture(scope="module")
def amazon_small():
    return (jax_synth("synth-amazon2m-small"),
            torch_synth("synth-amazon2m-small"))


def _assert_ds_equal(a, b):
    assert a.name == b.name and a.n_classes == b.n_classes
    for f in DS_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("name", ["synth-tiny", "synth-cora"])
def test_synthetic_dataset_byte_equal(name):
    _assert_ds_equal(jax_synth(name), load_dataset(name))


def test_synthetic_amazon_small_byte_equal(amazon_small):
    _assert_ds_equal(*amazon_small)


@pytest.mark.parametrize("psize,method", [(8, "refined"), (8, "bfs"),
                                          (3, "refined")])
def test_partition_list_identical(psize, method):
    ds = jax_synth("synth-cora")
    a = jax_parts(ds.senders, ds.receivers, ds.n_nodes, psize, seed=3,
                  method=method)
    b = torch_parts(ds.senders, ds.receivers, ds.n_nodes, psize, seed=3,
                    method=method)
    assert len(a) == len(b) == psize
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_partition_amazon_small_psize50(amazon_small):
    """The slice's clusters: psize 50 on the train-induced subgraph."""
    ds = amazon_small[0]
    train = np.nonzero(ds.train_mask)[0]
    s, r, _ = JG.subgraph(ds.senders, ds.receivers, train, ds.n_nodes)
    s2, r2, _ = TG.subgraph(ds.senders, ds.receivers, train, ds.n_nodes)
    np.testing.assert_array_equal(s, s2)
    np.testing.assert_array_equal(r, r2)
    a = jax_parts(s, r, len(train), 50)
    b = torch_parts(s2, r2, len(train), 50)
    assert len(a) == len(b) == 50
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


GRAPH_FIELDS = ("senders", "receivers", "indptr", "in_degrees",
                "out_degrees", "t_senders", "t_receivers", "t_indptr")


def _rand_edges(rng, n, e):
    return rng.integers(0, n, e), rng.integers(0, n, e)


@pytest.mark.parametrize("n,e,pad_to", [(50, 300, None), (300, 2000, 2400),
                                        (40, 0, None)])
def test_graph_from_edges_equal(rng, n, e, pad_to):
    s, r = _rand_edges(rng, n, e)
    a = JG.graph_from_edges(s, r, n, pad_to=pad_to)
    b = TG.graph_from_edges(s, r, n, pad_to=pad_to)
    assert (a.n_nodes, a.n_edges) == (b.n_nodes, b.n_edges)
    for f in GRAPH_FIELDS:
        x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    at, bt = a.transpose(), b.transpose()
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(at, f)),
                                      getattr(bt, f).numpy(), err_msg=f)


def _assert_tiles_equal(a, b):
    assert (a.tile_rows, a.cu, a.max_jobs) == (b.tile_rows, b.cu, b.max_jobs)
    for f in ("u_senders", "w_blocks", "job_offsets"):
        x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.pos is None) == (b.pos is None)
    if a.pos is not None:
        np.testing.assert_array_equal(np.asarray(a.pos), b.pos.numpy())
    assert a.perm is None  # the flat layout never permutes u


@pytest.mark.parametrize("reorder", [True, False])
@pytest.mark.parametrize("n,e", [(300, 2500), (1000, 6000)])
def test_dedup_tiles_equal(rng, reorder, n, e):
    s, r = _rand_edges(rng, n, e)
    gj = JG.graph_from_edges(s, r, n)
    gt = TG.graph_from_edges(s, r, n)
    for jt, tt in ((gj, gt), (gj.transpose(), gt.transpose())):
        m = jt.n_edges
        js_, jr = np.asarray(jt.senders[:m]), np.asarray(jt.receivers[:m])
        a = JG._build_dedup_tiles(js_, jr, n, reorder=reorder)
        b = TG._build_dedup_tiles(tt.senders[:m].numpy(),
                                  tt.receivers[:m].numpy(), n,
                                  reorder=reorder)
        _assert_tiles_equal(a, b)
        assert (b.pos is not None) == reorder
        _assert_tiles_equal(JG.pad_dedup_tiles(a, a.w_blocks.shape[0] + 5,
                                               a.max_jobs + 2),
                            TG.pad_dedup_tiles(b, b.w_blocks.shape[0] + 5,
                                               b.max_jobs + 2))


def test_with_tiles_equal(rng):
    """``graph_from_edges(tiles=True)``: forward and transpose layouts."""
    s, r = _rand_edges(rng, 400, 3000)
    a = JG.graph_from_edges(s, r, 400, tiles=True)
    b = TG.graph_from_edges(s, r, 400, tiles=True)
    _assert_tiles_equal(a.dedup, b.dedup)
    _assert_tiles_equal(a.dedup_t, b.dedup_t)
    _assert_tiles_equal(a.transpose().dedup, b.transpose().dedup)


def test_subgraph_equal(rng):
    s, r = _rand_edges(rng, 200, 1500)
    ids = rng.permutation(200)[:70]
    for x, y in zip(JG.subgraph(s, r, ids, 200), TG.subgraph(s, r, ids, 200)):
        np.testing.assert_array_equal(x, y)


def test_load_dataset_rejects_non_synthetic(tmp_path):
    """An unknown name raises KeyError; a real dataset's name without
    its files raises FileNotFoundError, never a synthetic stand-in."""
    with pytest.raises(KeyError):
        load_dataset("no-such-dataset")
    with pytest.raises(FileNotFoundError):
        load_dataset("cora", str(tmp_path))
