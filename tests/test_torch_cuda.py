"""The CUDA kernels against their plain PyTorch versions on the card:
K1 (the dedup SpMM) and K4–K6 (the dedup GAT attention and its fused
backward).  CUDA kernels have no CPU mode, so every test here skips
without a card.  On a machine with one (and without JAX), run:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gist_tpu_torch.graph import (_build_dedup_tiles, graph_from_edges,
                                  pad_dedup_tiles)
from gist_tpu_torch.ops import dedup_spmm as K
from gist_tpu_torch.ops import gat_dedup as G
from gist_tpu_torch.ops.spmm import aggregate, spmm_segment

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _edges(case, rng):
    if case == "several_tiles":
        n = 1000
        return rng.integers(0, n, 20000), rng.integers(0, n, 20000), n
    if case == "multi_job":
        # tile 0's 128 receivers with 20 random senders each: > 1024
        # unique senders, so tile 0 has several jobs
        n = 4096
        r = np.repeat(np.arange(128), 20)
        s = rng.integers(0, n, len(r))
        s2, r2 = rng.integers(0, n, 3000), rng.integers(0, n, 3000)
        return np.concatenate([s, s2]), np.concatenate([r, r2]), n
    if case == "empty_tiles":
        n = 512
        return rng.integers(0, n, 3000), rng.integers(0, 100, 3000), n
    if case == "multigraph":
        n = 300
        s, r = rng.integers(0, n, 400), rng.integers(0, n, 400)
        return np.repeat(s, 5), np.repeat(r, 5), n
    raise ValueError(case)


def _dense(s, r, n):
    a = np.zeros((n, n))
    np.add.at(a, (r, s), 1.0)
    return a


CASES = ["several_tiles", "multi_job", "empty_tiles", "multigraph"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype,f", [(torch.float32, 37), (torch.float32, 256),
                                     (torch.bfloat16, 100)])
def test_kernel_matches_plain(cuda, case, dtype, f):
    rng = np.random.default_rng(0)
    s, r, n = _edges(case, rng)
    d = _build_dedup_tiles(s, r, n, reorder=False)
    # padding jobs past job_offsets[-1] must never be read
    d = pad_dedup_tiles(d, int(d.w_blocks.shape[0]) + 3, d.max_jobs + 1)
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    x = x.to(dtype).to(cuda)
    dc = d.to(cuda)
    before = K.launches
    got = K.dedup_spmm(dc.job_offsets, dc.w_blocks, dc.u_senders, x)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    want = K.dedup_spmm_reference(dc.job_offsets, dc.w_blocks,
                                  dc.u_senders, x)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err <= (1e-5 if dtype == torch.float32 else 1e-2), err
    if dtype == torch.float32:
        oracle = _dense(s, r, n) @ x.double().cpu().numpy()
        np.testing.assert_allclose(got[:n].cpu().numpy(), oracle,
                                   rtol=1e-5, atol=1e-4)
    if case == "empty_tiles":
        assert torch.all(got[128:] == 0)


def test_aggregate_grad_runs_kernel(cuda):
    rng = np.random.default_rng(1)
    s, r, n = _edges("several_tiles", rng)
    g = graph_from_edges(s, r, n, tiles=True).to(cuda)
    assert g.dedup is not None and g.dedup.pos is not None  # reordered
    x0 = torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32))
    w = w.to(cuda)
    x = x0.to(cuda).requires_grad_(True)
    before = K.launches
    out = aggregate(g, x)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    assert K.launches == before + 2  # forward and transpose backward
    xs = x0.to(cuda).requires_grad_(True)
    want = spmm_segment(g, xs)
    (want * w).sum().backward()
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(x.grad, xs.grad, rtol=1e-5, atol=1e-4)


def test_kernel_raises_instead_of_falling_back(cuda):
    rng = np.random.default_rng(2)
    s, r, n = _edges("several_tiles", rng)
    g = graph_from_edges(s, r, n, tiles=True).to(cuda)
    d = g.dedup
    x = torch.ones((n, 8), device=cuda)
    with pytest.raises(TypeError):
        K.dedup_spmm(d.job_offsets, d.w_blocks, d.u_senders, x.double())
    with pytest.raises(TypeError):
        aggregate(g, x.half())
    with pytest.raises(ValueError):
        K.dedup_spmm(d.job_offsets, d.w_blocks, d.u_senders,
                     torch.ones((8, n), device=cuda).t())
    d64 = _build_dedup_tiles(s, r, n, tile_rows=64, reorder=False).to(cuda)
    with pytest.raises(ValueError):
        K.dedup_spmm(d64.job_offsets, d64.w_blocks, d64.u_senders, x)


# --- K4-K6: the dedup GAT attention ---------------------------------------


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _gat_inputs(d, n, heads, o, dtype, cuda, rng):
    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(cuda)
    return (t(n, heads, o).to(dtype), t(n, heads),
            t(d.num_tiles * 128, heads))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype,heads,o", [(torch.float32, 2, 37),
                                           (torch.float32, 1, 130),
                                           (torch.bfloat16, 2, 64)])
def test_gat_kernels_match_plain(cuda, case, dtype, heads, o):
    """K4, then K5 and K6 for head 0 on the forward's m and l, each
    against its plain version on the same inputs: 1e-5 (K4) and 1e-4
    (K5, K6; their row sums add four partial sums with atomics) relative
    to the plain result's max in fp32, 1e-2 in bf16."""
    rng = np.random.default_rng(0)
    s, r, n = _edges(case, rng)
    d = _build_dedup_tiles(s, r, n, reorder=False)
    d = pad_dedup_tiles(d, int(d.w_blocks.shape[0]) + 3, d.max_jobs + 1)
    dt = _build_dedup_tiles(r, s, n, reorder=False)
    d, dt = d.to(cuda), dt.to(cuda)
    z, src, dst_rows = _gat_inputs(d, n, heads, o, dtype, cuda, rng)
    lay = (d.job_offsets, d.w_blocks, d.u_senders)
    before = (G.launches_fwd, G.launches_b1, G.launches_b2)
    out, m, l = G.gat_fwd(*lay, z, src, dst_rows, 0.2)
    torch.cuda.synchronize()
    want = G.gat_fwd_reference(*lay, z, src, dst_rows, 0.2)
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _rel(out, want[0]) <= tol
    assert _rel(l, want[2]) <= 1e-5
    assert torch.equal(m, want[1]) or _rel(m, want[1]) <= 1e-6
    if case == "empty_tiles":
        assert torch.all(out[128:] == 0) and torch.all(l[128:] == 0)

    rows = d.num_tiles * 128
    g_rows = torch.from_numpy(
        rng.standard_normal((rows, o)).astype(np.float32)).to(cuda)
    c_rows = (out[:, 0].float() * g_rows).sum(1)
    args = (g_rows, z[:, 0].contiguous(), dst_rows[:, 0].contiguous(),
            src[:, 0].contiguous(), m[:, 0].contiguous(),
            l[:, 0].contiguous(), c_rows, 0.2)
    got = G.gat_bwd_b1(*lay, *args)
    torch.cuda.synchronize()
    tol_b = 1e-4 if dtype == torch.float32 else 1e-2
    assert _rel(got, G.gat_bwd_b1_reference(*lay, *args)) <= tol_b

    # K6 on the transpose layout: per-node stats of the forward rows
    lay_t = (dt.job_offsets, dt.w_blocks, dt.u_senders)
    rows_t = dt.num_tiles * 128
    z_rows = torch.zeros((rows_t, o), dtype=dtype, device=cuda)
    z_rows[:n] = z[:, 0]
    src_rows = torch.zeros(rows_t, device=cuda)
    src_rows[:n] = src[:, 0]
    args_t = (z_rows, src_rows, g_rows[:n].contiguous(),
              dst_rows[:n, 0].contiguous(), m[:n, 0].contiguous(),
              l[:n, 0].contiguous(), c_rows[:n].contiguous(), 0.2)
    dz, dsrc = G.gat_bwd_b2(*lay_t, *args_t)
    torch.cuda.synchronize()
    wz, wsrc = G.gat_bwd_b2_reference(*lay_t, *args_t)
    assert dz.dtype == dtype
    assert _rel(dz, wz) <= tol_b and _rel(dsrc, wsrc) <= tol_b
    assert (G.launches_fwd, G.launches_b1, G.launches_b2) == tuple(
        x + 1 for x in before)


@pytest.mark.parametrize("heads,o", [(2, 24), (3, 8)])
def test_gat_attention_grad_on_card(cuda, heads, o):
    """The autograd path on a reordered graph (pos set): one K4 launch,
    one K5 and one K6 per head, against the segment composite."""
    from gist_tpu_torch.ops.segment import gat_attention_segment
    rng = np.random.default_rng(3)
    s, r, n = _edges("several_tiles", rng)
    g = graph_from_edges(s, r, n, tiles=True).to(cuda)
    assert g.dedup.pos is not None

    def leaves():
        gen = np.random.default_rng(4)
        return [torch.from_numpy(gen.standard_normal(shape).astype(
            np.float32)).to(cuda).requires_grad_(True)
            for shape in ((n, heads, o), (n, heads), (n, heads))]
    w = torch.from_numpy(rng.standard_normal((n, heads, o)).astype(
        np.float32)).to(cuda)
    before = (G.launches_fwd, G.launches_b1, G.launches_b2)
    kl = leaves()
    out = G.gat_attention_dedup_mh(g, *kl, 0.01)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    assert (G.launches_fwd - before[0], G.launches_b1 - before[1],
            G.launches_b2 - before[2]) == (1, heads, heads)
    sl = leaves()
    ref = gat_attention_segment(g, *sl, 0.01)
    (ref * w).sum().backward()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    for a, b in zip(kl, sl):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4)


def test_gat_kernels_raise_instead_of_falling_back(cuda):
    rng = np.random.default_rng(2)
    s, r, n = _edges("several_tiles", rng)
    d = _build_dedup_tiles(s, r, n, reorder=False).to(cuda)
    z, src, dst_rows = _gat_inputs(d, n, 2, 8, torch.float32, cuda, rng)
    lay = (d.job_offsets, d.w_blocks, d.u_senders)
    with pytest.raises(TypeError):
        G.gat_fwd(*lay, z.double(), src, dst_rows, 0.01)
    with pytest.raises(ValueError):
        G.gat_fwd(*lay, z, src[:-1], dst_rows, 0.01)
    with pytest.raises(ValueError):
        G.gat_fwd(*lay, z, src, dst_rows.cpu(), 0.01)
    d64 = _build_dedup_tiles(s, r, n, tile_rows=64, reorder=False).to(cuda)
    with pytest.raises(ValueError):
        G.gat_fwd(d64.job_offsets, d64.w_blocks, d64.u_senders, z, src,
                  torch.zeros((d64.num_tiles * 64, 2), device=cuda), 0.01)
