"""The port's aggregation against the JAX package: K1's plain version
(``aggregate(backend="dedup")`` on CPU tensors) forward and autograd
gradient against the Pallas dedup kernel in interpret mode
(``spmm_pallas_csr``, ``jax.grad``) and against both segment paths.

Tolerance rtol = atol = 1e-4, the JAX kernel tests' own bar: the
interpret-mode kernel splits fp32 into hi/lo bf16 parts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gist_tpu.graph as JG
from gist_tpu.ops import pallas_spmm
from gist_tpu.ops.spmm import spmm_segment as jax_segment

import gist_tpu_torch.graph as TG
from gist_tpu_torch.ops import dedup_spmm as K
from gist_tpu_torch.ops import spmm as TS
from torch_port_helpers import load_jax_partitioner, run_interpret


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(s, r, n, *, reorder=False, pad=False):
    """The same graph and dedup layouts in both packages."""
    gj = JG.graph_from_edges(s, r, n)
    gt = TG.graph_from_edges(s, r, n)
    m = gj.n_edges
    layouts = []
    for jg, tg in ((gj, gt), (gj.transpose(), gt.transpose())):
        dj = JG._build_dedup_tiles(np.asarray(jg.senders[:m]),
                                   np.asarray(jg.receivers[:m]), n,
                                   reorder=reorder)
        dt = TG._build_dedup_tiles(tg.senders[:m].numpy(),
                                   tg.receivers[:m].numpy(), n,
                                   reorder=reorder)
        if pad:
            dj = JG.pad_dedup_tiles(dj, dj.w_blocks.shape[0] + 4,
                                    dj.max_jobs + 2)
            dt = TG.pad_dedup_tiles(dt, dt.w_blocks.shape[0] + 4,
                                    dt.max_jobs + 2)
        layouts.append((dj, dt))
    (dj, dt), (djt, dtt) = layouts
    return (gj.replace(dedup=dj, dedup_t=djt),
            gt.replace(dedup=dt, dedup_t=dtt))


def _case(name, rng):
    if name == "several_tiles":
        n = 600
        return rng.integers(0, n, 4000), rng.integers(0, n, 4000), n, {}
    if name == "multi_job":
        # tile 0's 128 receivers with 20 random senders each: > 1024
        # unique senders, so tile 0 carries more than one job
        n = 4096
        r = np.repeat(np.arange(128), 20)
        s = rng.integers(0, n, len(r))
        return s, r, n, {}
    if name == "empty_tiles":
        n = 256
        return rng.integers(0, n, 200), rng.integers(0, 100, 200), n, {}
    if name == "multigraph":
        n = 40
        s = np.array([1, 1, 1, 2, 5, 5] * 3)
        r = np.array([0, 0, 0, 0, 3, 3] * 3)
        return s, r, n, {}
    if name == "reordered":
        n = 400
        return (rng.integers(0, n, 3000), rng.integers(0, n, 3000), n,
                {"reorder": True})
    if name == "padded":
        n = 300
        return (rng.integers(0, n, 2000), rng.integers(0, n, 2000), n,
                {"pad": True})
    raise ValueError(name)


CASES = ["several_tiles", "multi_job", "empty_tiles", "multigraph",
         "reordered", "padded"]


@pytest.mark.parametrize("case", CASES)
def test_dedup_plain_matches_pallas_and_segment(rng, case):
    s, r, n, kw = _case(case, rng)
    gj, gt = _pair(s, r, n, **kw)
    if case == "multi_job":
        assert gt.dedup.max_jobs > 1
    if case == "reordered":
        assert gt.dedup.pos is not None
    f = 12
    x = rng.standard_normal((n, f)).astype(np.float32)
    w = rng.standard_normal((n, f)).astype(np.float32)

    want, want_dx = run_interpret(lambda: (
        pallas_spmm.spmm_pallas_csr(gj, jnp.asarray(x)),
        jax.grad(lambda v: jnp.sum(
            pallas_spmm.spmm_pallas_csr(gj, v) * w))(jnp.asarray(x))))
    seg = np.asarray(jax_segment(gj, jnp.asarray(x)))

    xt = torch.from_numpy(x).requires_grad_(True)
    got = TS.aggregate(gt, xt, backend="dedup")
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(got.detach().numpy(), seg, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, **TOL)
    np.testing.assert_allclose(TS.spmm_segment(gt, torch.from_numpy(x))
                               .numpy(), seg, **TOL)
    if case == "empty_tiles":
        assert np.all(got.detach().numpy()[128:] == 0)


def test_plain_walk_bf16_accumulates_fp32(rng):
    s, r, n, _ = _case("several_tiles", rng)
    _, gt = _pair(s, r, n)
    x = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    got = TS.aggregate(gt, x.bfloat16(), backend="dedup")
    assert got.dtype == torch.bfloat16
    want = TS.spmm_segment(gt, x.bfloat16().float())
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2)


def test_segment_chunked_and_padding(rng):
    s, r = rng.integers(0, 90, 700), rng.integers(0, 90, 700)
    gj = JG.graph_from_edges(s, r, 90, pad_to=1000)
    gt = TG.graph_from_edges(s, r, 90, pad_to=1000)
    x = rng.standard_normal((90, 5)).astype(np.float32)
    want = np.asarray(jax_segment(gj, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(TS.spmm_segment(gt, xt).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TS.spmm_segment_chunked(gt, xt, edge_chunk=128).numpy(), want,
        rtol=1e-5, atol=1e-5)


def test_auto_backend_resolution(rng):
    s, r, n, _ = _case("several_tiles", rng)
    _, gt = _pair(s, r, n)
    assert TS.resolve_backend(gt) == "segment"        # CPU tensors
    assert TS.resolve_backend(gt, "dedup") == "dedup"
    with pytest.raises(ValueError):
        TS.set_default_backend("pallas")
    with pytest.raises(ValueError):
        TS.aggregate(TG.graph_from_edges(s, r, n), torch.zeros(n, 2),
                     backend="dedup")                  # no layout


def test_kernel_wrapper_rejects_unsupported_input(rng):
    """The CUDA wrapper raises on what the kernel does not take; it
    never falls back to the plain version."""
    s, r, n, _ = _case("several_tiles", rng)
    _, gt = _pair(s, r, n)
    d = gt.dedup
    x = torch.zeros((n, 4))
    with pytest.raises(TypeError):
        K._check(d.job_offsets, d.w_blocks, d.u_senders, x.double())
    with pytest.raises(ValueError):
        K._check(d.job_offsets, d.w_blocks, d.u_senders, x[:, 0])
    # K1 has instances for TN 64, 128 and 256; a layout of 32-row tiles
    # has none
    d32 = TG._build_dedup_tiles(s, r, n, tile_rows=32, reorder=False)
    with pytest.raises(ValueError):
        K._check(d32.job_offsets, d32.w_blocks, d32.u_senders, x)
    with pytest.raises(ValueError):
        K.dedup_spmm(d.job_offsets.to("meta"), d.w_blocks.to("meta"),
                     d.u_senders.to("meta"), x.to("meta"))
