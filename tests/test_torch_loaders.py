"""The port's on-disk loaders (``gist_tpu_torch.data.loaders``) against
the JAX package's on fabricated fixture files in each real format,
written by ``tests/test_loader_fixtures.py``'s writers: every array of
the dataset equal, the missing-file errors, and the amazon2m cache read
across the two packages."""

import os

import numpy as np
import pytest

from gist_tpu.data import loaders as JL
from test_loader_fixtures import (_write_amazon, _write_planetoid, _write_ppi,
                                  _write_reddit)

from gist_tpu_torch.data import load_dataset
from gist_tpu_torch.data import loaders as TL

ARRAYS = ("senders", "receivers", "features", "labels", "train_mask",
          "val_mask", "test_mask")


def _assert_same(got, want):
    assert got.name == want.name
    assert got.n_classes == want.n_classes
    assert got.n_nodes == want.n_nodes
    for k in ARRAYS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    if want.labels_multi is None:
        assert got.labels_multi is None
    else:
        np.testing.assert_array_equal(got.labels_multi, want.labels_multi)


@pytest.mark.parametrize("name,kw", [
    ("cora", {}), ("cora", {"seed": 3}),
    ("citeseer", {"seed": 7, "gaps": 9}), ("pubmed", {"seed": 1})])
def test_planetoid_equal(tmp_path, name, kw):
    _write_planetoid(str(tmp_path), name=name, **kw)
    _assert_same(load_dataset(name, str(tmp_path)),
                 JL.load_dataset(name, str(tmp_path)))


@pytest.mark.parametrize("name", ["reddit", "reddit-self-loop"])
@pytest.mark.parametrize("self_loop", [False, True])
def test_reddit_equal(tmp_path, name, self_loop):
    _write_reddit(str(tmp_path))
    _assert_same(load_dataset(name, str(tmp_path), self_loop=self_loop),
                 JL.load_dataset(name, str(tmp_path), self_loop=self_loop))


def test_ppi_equal_multi_hot(tmp_path):
    _write_ppi(str(tmp_path))
    got = load_dataset("ppi", str(tmp_path))
    _assert_same(got, JL.load_dataset("ppi", str(tmp_path)))
    assert got.multitask and got.labels_multi.dtype == np.float32


def test_amazon2m_equal_and_cache_shared(tmp_path):
    """The port parses the files and writes the cache; the JAX loader
    then reads the port's cache, and the port reads one the JAX loader
    wrote, all equal to a parse."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    for d in (port_dir, jax_dir):
        d.mkdir()
        _write_amazon(str(d))
    parsed = load_dataset("amazon2m", str(port_dir))
    want = JL.load_dataset("amazon2m", str(jax_dir))
    _assert_same(parsed, want)
    cache = port_dir / "amazon2M-processed.npz"
    assert cache.exists()
    os.remove(port_dir / "amazon2M-G.json")      # only the cache is left
    _assert_same(JL.load_dataset("amazon2m", str(port_dir)), want)
    _assert_same(load_dataset("amazon2m", str(port_dir)), want)
    os.remove(jax_dir / "amazon2M-G.json")
    _assert_same(load_dataset("amazon2m", str(jax_dir)), want)


@pytest.mark.parametrize("name,expect", [
    ("cora", "ind.cora.x"), ("citeseer", "ind.citeseer.test.index"),
    ("reddit", "reddit_data.npz"), ("reddit-self-loop", "reddit_data.npz"),
    ("amazon2m", "amazon2M-G.json"), ("ppi", "train_graph.json")])
def test_missing_files_raise(tmp_path, name, expect):
    """No silent synthetic stand-in: the error names the expected
    file."""
    with pytest.raises(FileNotFoundError, match=expect):
        load_dataset(name, str(tmp_path / "nope"))


@pytest.mark.parametrize("name,self_loop", [
    ("synth-tiny", False), ("synth-tiny", True), ("synth-cora", False)])
def test_synthetic_branch_equal(name, self_loop):
    _assert_same(load_dataset(name, self_loop=self_loop, seed=2),
                 JL.load_dataset(name, self_loop=self_loop, seed=2))


def test_unknown_name_raises():
    with pytest.raises(KeyError):
        load_dataset("not-a-dataset")
    assert TL.PLANETOID == JL.PLANETOID
