"""The chunked and split dedup layouts and their runners against the JAX
package: the layout arrays equal, ``with_tiles``' decision order, and
the plain chunked-K1 and K2 runners (forward and the gradient through
the transpose layouts) against the interpret-mode Pallas runners and
the segment path.

Tolerance rtol = atol = 1e-4, the JAX kernel tests' own bar: the
interpret-mode kernels split fp32 into hi/lo bf16 parts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gist_tpu.graph as JG
from conftest import make_random_graph
from gist_tpu.ops import pallas_spmm
from gist_tpu.ops.spmm import spmm_segment as jax_segment

import gist_tpu_torch.graph as TG
from gist_tpu_torch.data import load_dataset
from gist_tpu_torch.ops import dedup_spmm as K
from gist_tpu_torch.ops import split_spmm as K2
from gist_tpu_torch.ops import spmm as TS
from torch_port_helpers import load_jax_partitioner, run_interpret


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


TOL = dict(rtol=1e-4, atol=1e-4)
FIELDS = ("u_senders", "w_blocks", "job_offsets", "pos", "perm", "dir_blk",
          "rem_blk", "is_dir")


def _assert_chunked_equal(a, b):
    assert (a.tile_rows, a.cu, a.max_jobs, a.num_tiles) == (
        b.tile_rows, b.cu, b.max_jobs, b.num_tiles)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            x, y = np.asarray(x), y.numpy()
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def _split_edges(rng, n=3000):
    """The JAX split test's graph: hub receivers fed from one source
    block (dense pairs) plus a sparse scatter."""
    hub_r = np.repeat(rng.integers(0, n, 20), 30)
    hub_s = rng.integers(0, 1024, len(hub_r))
    sc_s, sc_r = make_random_graph(rng, n, 4000)
    return np.concatenate([hub_s, sc_s]), np.concatenate([hub_r, sc_r]), n


SPLIT_CASES = [
    (4, 1 << 20, 1024),    # most pairs direct, one chunk
    (8, 2048, 1024),       # mixed direct/remote, many chunks
    (10 ** 9, 4096, 1024),  # all remote (pure gather)
    (8, 2048, 512),        # CU 512
]


@pytest.mark.parametrize("chunk_rows", [1 << 20, 4096, 2048])
def test_chunked_layout_equal(rng, chunk_rows):
    s, r = make_random_graph(rng, 600, 4000)
    gj = JG.graph_from_edges(s, r, 600)
    gt = TG.graph_from_edges(s, r, 600)
    for jg, tg in ((gj, gt), (gj.transpose(), gt.transpose())):
        m = jg.n_edges
        a = JG._build_dedup_chunked(np.asarray(jg.senders[:m]),
                                    np.asarray(jg.receivers[:m]), 600,
                                    chunk_rows=chunk_rows)
        b = TG._build_dedup_chunked(tg.senders[:m].numpy(),
                                    tg.receivers[:m].numpy(), 600,
                                    chunk_rows=chunk_rows)
        _assert_chunked_equal(a, b)
        assert b.perm is not None and b.is_dir is None
        assert not np.array_equal(b.perm.numpy(), np.arange(600))
        if chunk_rows == 2048:
            assert b.n_chunks > 2


@pytest.mark.parametrize("threshold,chunk_rows,cu", SPLIT_CASES)
def test_split_layout_equal(rng, threshold, chunk_rows, cu):
    s, r, n = _split_edges(rng)
    a = JG._build_dedup_split_chunked(s, r, n, tile_rows=64, cu=cu,
                                      threshold=threshold,
                                      chunk_rows=chunk_rows)
    b = TG._build_dedup_split_chunked(s, r, n, tile_rows=64, cu=cu,
                                      threshold=threshold,
                                      chunk_rows=chunk_rows)
    _assert_chunked_equal(a, b)
    direct = int(b.is_dir.sum())
    assert direct > 0 if threshold < 10 ** 9 else direct == 0


def test_with_tiles_forced_chunked_equal(rng):
    s, r = make_random_graph(rng, 500, 3000)
    a = JG.graph_from_edges(s, r, 500).with_tiles(mode="dedup-chunked",
                                                  chunk_rows=2048)
    b = TG.graph_from_edges(s, r, 500).with_tiles(mode="dedup-chunked",
                                                  chunk_rows=2048)
    assert b.dedup is None and b.dedup_c.n_chunks > 1
    _assert_chunked_equal(a.dedup_c, b.dedup_c)
    _assert_chunked_equal(a.dedup_c_t, b.dedup_c_t)
    _assert_chunked_equal(a.transpose().dedup_c, b.transpose().dedup_c)
    assert b.with_tiles(mode="dedup-chunked") is b     # no-op if present
    bt = b.to("cpu")
    assert bt.dedup_c.w_blocks.data_ptr() == b.dedup_c.w_blocks.data_ptr()


def test_with_tiles_forward_only(rng):
    s, r = make_random_graph(rng, 100, 400)
    g = TG.graph_from_edges(s, r, 100).with_tiles(
        mode="dedup-chunked", chunk_rows=1024, transpose=False)
    assert g.dedup_c is not None and g.dedup_c_t is None
    x = torch.from_numpy(rng.standard_normal((100, 4)).astype(np.float32))
    TS.aggregate(g, x, backend="dedup")             # forward runs
    with pytest.raises(NotImplementedError):
        TS.aggregate(g, x.requires_grad_(True), backend="dedup").sum() \
            .backward()


def test_with_tiles_above_lowered_threshold(rng, monkeypatch):
    """Above ``HUGE_EDGES`` the default mode builds the chunked pair, as
    the JAX package's ``mode="dedup-chunked"`` does."""
    s, r = make_random_graph(rng, 400, 2500)
    monkeypatch.setattr(TG, "HUGE_EDGES", 1000)
    b = TG.graph_from_edges(s, r, 400, tiles=True)
    a = JG.graph_from_edges(s, r, 400).with_tiles(mode="dedup-chunked")
    assert b.dedup is None and b.dedup_c is not None
    _assert_chunked_equal(a.dedup_c, b.dedup_c)
    _assert_chunked_equal(a.dedup_c_t, b.dedup_c_t)
    monkeypatch.setattr(TG, "HUGE_EDGES", 10 ** 9)
    flat = TG.graph_from_edges(s, r, 400, tiles=True)
    assert flat.dedup is not None and flat.dedup_c is None
    both = flat.with_tiles(mode="gather")    # the v1 pair beside the flat one
    assert both.dedup is flat.dedup and both.tiled is not None
    assert both.tiled_t.pos_in_other is not None
    with pytest.raises(ValueError):
        flat.with_tiles(mode="tiled")


def test_add_self_loops_equal(rng):
    s = rng.integers(0, 50, 300)
    r = np.where(rng.random(300) < 0.2, s, rng.integers(0, 50, 300))
    for dedup in (True, False):
        for x, y in zip(JG.add_self_loops(s, r, 50, dedup=dedup),
                        TG.add_self_loops(s, r, 50, dedup=dedup)):
            np.testing.assert_array_equal(x, y)


def test_load_dataset_self_loop_equal():
    from gist_tpu.data import load_dataset as jax_load
    a = jax_load("synth-tiny", self_loop=True)
    b = load_dataset("synth-tiny", self_loop=True)
    np.testing.assert_array_equal(a.senders, b.senders)
    np.testing.assert_array_equal(a.receivers, b.receivers)
    loops = b.senders == b.receivers
    assert loops.sum() == b.n_nodes
    np.testing.assert_array_equal(np.sort(b.senders[loops]),
                                  np.arange(b.n_nodes))


def _jax_spmm_and_grad(gj, x, w):
    return run_interpret(lambda: (
        pallas_spmm.spmm_pallas_csr(gj, jnp.array(x)),
        jax.grad(lambda v: jnp.sum(pallas_spmm.spmm_pallas_csr(gj, v) * w))(
            jnp.array(x))))


def _port_spmm_and_grad(gt, x, w):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = TS.aggregate(gt, xt, backend="dedup")
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("chunk_rows", [2048, 1 << 20])
def test_chunked_runner_matches_pallas_and_segment(rng, chunk_rows):
    n, f = 600, 24
    s, r = make_random_graph(rng, n, 4000)
    gj = JG.graph_from_edges(s, r, n).with_tiles(mode="dedup-chunked",
                                                 chunk_rows=chunk_rows)
    gt = TG.graph_from_edges(s, r, n).with_tiles(mode="dedup-chunked",
                                                 chunk_rows=chunk_rows)
    assert TS.resolve_backend(gt) == "segment"      # CPU tensors
    x = rng.standard_normal((n, f)).astype(np.float32)
    w = rng.standard_normal((n, f)).astype(np.float32)
    got, got_dx = _port_spmm_and_grad(gt, x, w)
    want, want_dx = _jax_spmm_and_grad(gj, x, w)
    seg = np.asarray(jax_segment(gj, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, seg, **TOL)
    np.testing.assert_allclose(got_dx, want_dx, **TOL)
    np.testing.assert_allclose(
        got_dx, np.asarray(jax_segment(gj.transpose(), jnp.asarray(w))),
        **TOL)


def _split_pair(s, r, n, threshold, chunk_rows, cu):
    """The same graph in both packages carrying the split layout pair
    (forward, and transpose built from the transpose edges)."""
    gj = JG.graph_from_edges(s, r, n)
    gt = TG.graph_from_edges(s, r, n)
    m = gt.n_edges
    kw = dict(tile_rows=64, cu=cu, threshold=threshold,
              chunk_rows=chunk_rows)
    lay_j = [JG._build_dedup_split_chunked(
        np.asarray(a[:m]), np.asarray(b[:m]), n, **kw).to_device()
        for a, b in ((gj.senders, gj.receivers),
                     (gj.t_senders, gj.t_receivers))]
    lay_t = [TG._build_dedup_split_chunked(a[:m].numpy(), b[:m].numpy(), n,
                                           **kw)
             for a, b in ((gt.senders, gt.receivers),
                          (gt.t_senders, gt.t_receivers))]
    return (gj.replace(dedup_c=lay_j[0], dedup_c_t=lay_j[1]),
            gt.replace(dedup_c=lay_t[0], dedup_c_t=lay_t[1]))


@pytest.mark.parametrize("threshold,chunk_rows,cu", SPLIT_CASES)
def test_split_runner_matches_pallas_and_segment(rng, threshold, chunk_rows,
                                                 cu):
    s, r, n = _split_edges(rng)
    gj, gt = _split_pair(s, r, n, threshold, chunk_rows, cu)
    f = 16
    x = rng.standard_normal((n, f)).astype(np.float32)
    w = rng.standard_normal((n, f)).astype(np.float32)
    got_run = K.run_dedup_chunked(gt.dedup_c, torch.from_numpy(x), n)
    got, got_dx = _port_spmm_and_grad(gt, x, w)
    want_run = run_interpret(lambda: pallas_spmm._run_dedup_split_chunked(
        gj.dedup_c, jnp.array(x), n))
    np.testing.assert_allclose(got_run.numpy(), want_run, **TOL)
    np.testing.assert_allclose(got, got_run.numpy(), rtol=0, atol=0)
    seg = np.asarray(jax_segment(gj, jnp.asarray(x)))
    np.testing.assert_allclose(got, seg, **TOL)
    seg_dx = np.asarray(jax_segment(gj.transpose(), jnp.asarray(w)))
    np.testing.assert_allclose(got_dx, seg_dx, **TOL)
    if (threshold, cu) == (8, 1024):     # the mixed case, through jax.grad
        want, want_dx = _jax_spmm_and_grad(gj, x, w)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got_dx, want_dx, **TOL)


def test_split_plain_walk_bf16_and_tail_block(rng):
    """bf16 accumulates in fp32; a direct block that runs past the last
    row reads zeros (x is not padded to a CU multiple)."""
    s, r, n = _split_edges(rng, n=1100)         # last block: rows 1024..1099
    t = TG._build_dedup_split_chunked(s, r, n, tile_rows=64, cu=1024,
                                      threshold=1, chunk_rows=1 << 20)
    assert int(t.is_dir.sum()) > 0 and t.dir_blk.max() == 1
    x = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    g = TG.graph_from_edges(s, r, n)
    got = K.run_dedup_chunked(t, x.bfloat16(), n)
    assert got.dtype == torch.bfloat16
    want = TS.spmm_segment(g, x.bfloat16().float())
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(K.run_dedup_chunked(t, x, n).numpy(),
                               TS.spmm_segment(g, x).numpy(), **TOL)


def test_split_wrapper_rejects_unsupported_input(rng):
    """The CUDA wrapper's checks raise on what the kernel does not take;
    it never falls back to the plain version."""
    s, r, n = _split_edges(rng, n=1100)
    t = TG._build_dedup_split_chunked(s, r, n, tile_rows=64, threshold=8)
    lay = (t.job_offsets[0], t.dir_blk[0], t.rem_blk[0], t.is_dir[0],
           t.w_blocks[0], t.u_senders[0])
    x = torch.zeros((n, 4))
    out = torch.zeros((t.tiles_per_chunk * 64, 4))
    with pytest.raises(TypeError):
        K2._check(*lay, x.double(), out.double())
    with pytest.raises(ValueError):
        K2._check(*lay, x, out[:-1])
    t32 = TG._build_dedup_split_chunked(s, r, n, tile_rows=32, threshold=8)
    lay32 = (t32.job_offsets[0], t32.dir_blk[0], t32.rem_blk[0],
             t32.is_dir[0], t32.w_blocks[0], t32.u_senders[0])
    with pytest.raises(ValueError):
        K2._check(*lay32, x, torch.zeros((t32.tiles_per_chunk * 32, 4)))
    with pytest.raises(ValueError):
        K2.split_spmm(*(a.to("meta") for a in lay), x.to("meta"))
