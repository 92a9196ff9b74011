"""The CUDA kernels against their plain PyTorch versions on the card:
K1 (the dedup SpMM), K2 (the split SpMM), K3 (the v1 SpMM), K4–K6 (the
dedup GAT attention and its fused backward), K7–K9 (the v1 GAT
attention and its fused backward) and S1 (the segment path's CSR row
walk).  CUDA kernels have no CPU mode, so
every test here skips without a card.  On a machine with one (and
without JAX), run:

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
    if case == "hub":
        # row 7 with 3,500 in-edges: batches of slots and the online
        # softmax's rescale wrap many times
        n = 1500
        s = rng.integers(0, n, 8500)
        r = np.concatenate([rng.integers(0, n, 5000), np.full(3500, 7)])
        return s, r, n
    raise ValueError(case)


def _dense(s, r, n):
    a = np.zeros((n, n))
    np.add.at(a, (r, s), 1.0)
    return a


CASES = ["several_tiles", "multi_job", "empty_tiles", "multigraph"]
# cases that edit the counts of one job after the build, for the sparse
# walk of K1 and K2: all zero, every count 127 (a full list for every
# row), one nonzero in the last slot of the last step
W_EDITS = ["zero_job", "full_counts", "last_slot"]


def _edit_counts(w, job, edit):
    """Edit ``w[job]`` (int8, (TN, CU)) in place."""
    if edit == "zero_job":
        w[job] = 0
    elif edit == "full_counts":
        w[job] = 127
    else:
        w[job] = 0
        w[job, -1, -1] = 3


# F across the slice edges (1, 64, 128 + 1) and pointer or row widths that
# are not 16-byte multiples (37, 100, 602); bf16 at odd F copies rows two
# bytes at a time
K1_WIDTHS = [(torch.float32, 1), (torch.float32, 37), (torch.float32, 64),
             (torch.float32, 100), (torch.float32, 129),
             (torch.float32, 256), (torch.float32, 602),
             (torch.bfloat16, 100), (torch.bfloat16, 37)]


@pytest.mark.parametrize("case", CASES + W_EDITS)
@pytest.mark.parametrize("dtype,f", K1_WIDTHS)
def test_kernel_matches_plain(cuda, case, dtype, f):
    """K1 against its plain walk (1e-5 relative to the plain result's max
    in fp32, 1e-2 in bf16) and, on unedited layouts in fp32, against the
    dense product; two launches give the same bits (no atomics)."""
    rng = np.random.default_rng(0)
    s, r, n = _edges("multi_job" if case in W_EDITS else case, rng)
    d = _build_dedup_tiles(s, r, n, reorder=False)
    # padding jobs past job_offsets[-1] must never be read
    d = pad_dedup_tiles(d, int(d.w_blocks.shape[0]) + 3, d.max_jobs + 1)
    if case in W_EDITS:
        # the last job of tile 0, which holds several
        _edit_counts(d.w_blocks, int(d.job_offsets[1]) - 1, case)
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    x = x.to(dtype).to(cuda)
    dc = d.to(cuda)
    before = K.launches
    got = K.dedup_spmm(dc.job_offsets, dc.w_blocks, dc.u_senders, x)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    assert torch.equal(got, K.dedup_spmm(dc.job_offsets, dc.w_blocks,
                                         dc.u_senders, x))
    want = K.dedup_spmm_reference(dc.job_offsets, dc.w_blocks,
                                  dc.u_senders, x)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max() / \
        want.float().abs().max().clamp(min=1e-30)
    assert err <= (1e-5 if dtype == torch.float32 else 1e-2), err
    if dtype == torch.float32 and case not in W_EDITS:
        oracle = _dense(s, r, n) @ x.double().cpu().numpy()
        np.testing.assert_allclose(got[:n].cpu().numpy(), oracle,
                                   rtol=1e-5, atol=1e-4)
    if case == "empty_tiles":
        assert torch.all(got[128:] == 0)


@pytest.mark.parametrize("tn", [64, 256])
@pytest.mark.parametrize("case", ["several_tiles", "multi_job",
                                  "empty_tiles"])
@pytest.mark.parametrize("dtype,f", [(torch.float32, 602),
                                     (torch.float32, 37),
                                     (torch.bfloat16, 100)])
def test_kernel_tile_sizes_match_plain(cuda, tn, case, dtype, f):
    """K1 at the tile sizes of the chunked layouts and of the tile sweep
    (TN 64 and 256) against its plain walk: 1e-5 relative to the plain
    result's max in fp32 (1e-2 bf16), (num_tiles * TN, F) rows, two
    launches bitwise equal, rows of tiles without jobs zero."""
    rng = np.random.default_rng(tn)
    s, r, n = _edges(case, rng)
    d = _build_dedup_tiles(s, r, n, tile_rows=tn, reorder=False)
    d = pad_dedup_tiles(d, int(d.w_blocks.shape[0]) + 3, d.max_jobs + 1)
    d = d.to(cuda)
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    x = x.to(dtype).to(cuda)
    before = K.launches
    got = K.dedup_spmm(d.job_offsets, d.w_blocks, d.u_senders, x)
    again = K.dedup_spmm(d.job_offsets, d.w_blocks, d.u_senders, x)
    torch.cuda.synchronize()
    assert K.launches == before + 2
    assert got.shape == (d.num_tiles * tn, f) and torch.equal(got, again)
    want = K.dedup_spmm_reference(d.job_offsets, d.w_blocks, d.u_senders,
                                  x)
    assert _rel(got, want) <= (1e-5 if dtype == torch.float32 else 1e-2)
    if case == "empty_tiles":      # receivers below 100 only
        assert torch.all(got[-(-100 // tn) * tn:] == 0)


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
    # TN 64, 128 and 256 have instances; 32-row tiles have none
    d32 = _build_dedup_tiles(s, r, n, tile_rows=32, reorder=False).to(cuda)
    with pytest.raises(ValueError):
        K.dedup_spmm(d32.job_offsets, d32.w_blocks, d32.u_senders, x)


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
    against its plain version on the same inputs: 1e-5 (K4) and 1e-4 (K5
    and K6, whose dot products and row sums run in another order than
    the plain version's matrix products) relative to the plain result's
    max in fp32, 1e-2 in bf16."""
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


def _nan_blocks(cuda, *specs):
    """Allocate and free NaN-filled blocks of these (shape, dtype), so
    that the next allocations of those sizes come back full of NaN and a
    kernel that leaves an element unwritten shows."""
    torch.cuda.synchronize()
    for shape, dtype in specs:
        torch.full(shape, float("nan"), dtype=dtype, device=cuda)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype,o", [(torch.float32, 1),
                                     (torch.float32, 37),
                                     (torch.float32, 41),
                                     (torch.float32, 130),
                                     (torch.float32, 257),
                                     (torch.float32, 602),
                                     (torch.bfloat16, 64)])
def test_gat_bwd_b2_matches_plain(cuda, case, dtype, o):
    """K6 on the transpose layout (padding jobs, empty tiles) against its
    plain version on the forward's m and l: 1e-4 relative to the plain
    result's max in fp32, 1e-2 in bf16; two launches give the same bits;
    every element of dz and dsrc is written (the wrapper allocates them
    with ``torch.empty``: blocks just freed full of NaN come back)."""
    rng = np.random.default_rng(5)
    s, r, n = _edges(case, rng)
    if case == "empty_tiles":   # senders in [0, 100): the transpose
        s, r = r, s             # layout's tiles past 0 hold no row
    d = _build_dedup_tiles(s, r, n, reorder=False).to(cuda)
    dt = _build_dedup_tiles(r, s, n, reorder=False)
    dt = pad_dedup_tiles(dt, int(dt.w_blocks.shape[0]) + 3,
                         dt.max_jobs + 1).to(cuda)
    z, src, dst_rows = _gat_inputs(d, n, 1, o, dtype, cuda, rng)
    lay = (d.job_offsets, d.w_blocks, d.u_senders)
    out, m, l = G.gat_fwd(*lay, z, src, dst_rows, 0.2)
    rows_t = dt.num_tiles * 128
    z_rows = torch.zeros((rows_t, o), dtype=dtype, device=cuda)
    z_rows[:n] = z[:, 0]
    src_rows = torch.zeros(rows_t, device=cuda)
    src_rows[:n] = src[:, 0]
    g = torch.from_numpy(rng.standard_normal((n, o)).astype(
        np.float32)).to(cuda)
    c = (out[:n, 0].float() * g).sum(1)
    args = (dt.job_offsets, dt.w_blocks, dt.u_senders, z_rows, src_rows, g,
            dst_rows[:n, 0].contiguous(), m[:n, 0].contiguous(),
            l[:n, 0].contiguous(), c, 0.2)
    _nan_blocks(cuda, ((rows_t, o), dtype), ((rows_t,), torch.float32))
    before = G.launches_b2
    dz, dsrc = G.gat_bwd_b2(*args)
    torch.cuda.synchronize()
    assert G.launches_b2 == before + 1
    assert torch.isfinite(dz.float()).all() and torch.isfinite(dsrc).all()
    dz2, dsrc2 = G.gat_bwd_b2(*args)
    assert torch.equal(dz, dz2) and torch.equal(dsrc, dsrc2)
    wz, wsrc = G.gat_bwd_b2_reference(*args)
    assert dz.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert _rel(dz, wz) <= tol and _rel(dsrc, wsrc) <= tol
    if case == "empty_tiles":
        assert torch.all(dz[128:] == 0) and torch.all(dsrc[128:] == 0)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype,o", [(torch.float32, 1),
                                     (torch.float32, 37),
                                     (torch.float32, 41),
                                     (torch.float32, 130),
                                     (torch.float32, 257),
                                     (torch.float32, 602),
                                     (torch.bfloat16, 64)])
def test_gat_bwd_b1_matches_plain(cuda, case, dtype, o):
    """K5 on the forward layout (padding jobs, empty tiles) against its
    plain version on the forward's m and l: 1e-4 relative to the plain
    result's max in fp32, 1e-2 in bf16; two launches give the same bits;
    every element of ddst is written (the wrapper allocates it with
    ``torch.empty``: a block just freed full of NaN comes back)."""
    rng = np.random.default_rng(6)
    s, r, n = _edges(case, rng)
    d = _build_dedup_tiles(s, r, n, reorder=False)
    d = pad_dedup_tiles(d, int(d.w_blocks.shape[0]) + 3,
                        d.max_jobs + 1).to(cuda)
    z, src, dst_rows = _gat_inputs(d, n, 1, o, dtype, cuda, rng)
    lay = (d.job_offsets, d.w_blocks, d.u_senders)
    out, m, l = G.gat_fwd(*lay, z, src, dst_rows, 0.2)
    rows = d.num_tiles * 128
    g_rows = torch.from_numpy(
        rng.standard_normal((rows, o)).astype(np.float32)).to(cuda)
    c_rows = (out[:, 0].float() * g_rows).sum(1)
    args = lay + (g_rows, z[:, 0].contiguous(), dst_rows[:, 0].contiguous(),
                  src[:, 0].contiguous(), m[:, 0].contiguous(),
                  l[:, 0].contiguous(), c_rows, 0.2)
    _nan_blocks(cuda, ((rows,), torch.float32))
    before = G.launches_b1
    got = G.gat_bwd_b1(*args)
    torch.cuda.synchronize()
    assert G.launches_b1 == before + 1
    assert got.dtype == torch.float32 and got.shape == (rows,)
    assert torch.isfinite(got).all()
    assert torch.equal(got, G.gat_bwd_b1(*args))
    err = _rel(got, G.gat_bwd_b1_reference(*args))
    assert err <= (1e-4 if dtype == torch.float32 else 1e-2), err
    if case == "empty_tiles":
        assert torch.all(got[128:] == 0)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype,heads,o", [
    *[(torch.float32, h, o) for h in (1, 2, 3, 4)
      for o in (37, 256, 257, 602)],
    (torch.bfloat16, 2, 64), (torch.bfloat16, 3, 257)])
def test_gat_fwd_matches_plain(cuda, case, dtype, heads, o):
    """K4 (padding jobs, empty tiles, one to four heads) against its
    plain version: out to 1e-5 relative to the plain result's max in
    fp32 (1e-2 in bf16), l to 1e-5, m exact or to 1e-6; every element of
    out, m and l is written (the wrapper allocates them with
    ``torch.empty`` into blocks just freed full of NaN); two launches
    give the same bits; a call with ``out=`` a slice of a larger
    NaN-filled tensor (a chunk of the chunked layout) writes that slice
    alone, with the same bits."""
    rng = np.random.default_rng(7)
    s, r, n = _edges(case, rng)
    d = _build_dedup_tiles(s, r, n, reorder=False)
    d = pad_dedup_tiles(d, int(d.w_blocks.shape[0]) + 3,
                        d.max_jobs + 1).to(cuda)
    z, src, dst_rows = _gat_inputs(d, n, heads, o, dtype, cuda, rng)
    args = (d.job_offsets, d.w_blocks, d.u_senders, z, src, dst_rows, 0.2)
    rows = d.num_tiles * 128
    _nan_blocks(cuda, ((rows, heads, o), dtype),
                ((rows, heads), torch.float32),
                ((rows, heads), torch.float32))
    before = G.launches_fwd
    out, m, l = G.gat_fwd(*args)
    torch.cuda.synchronize()
    assert G.launches_fwd == before + 1
    assert out.dtype == dtype and out.shape == (rows, heads, o)
    for t in (out, m, l):
        assert not torch.isnan(t.float()).any()
    again = G.gat_fwd(*args)
    assert all(torch.equal(a, b) for a, b in zip((out, m, l), again))
    w_out, w_m, w_l = G.gat_fwd_reference(*args)
    assert _rel(out, w_out) <= (1e-5 if dtype == torch.float32 else 1e-2)
    assert _rel(l, w_l) <= 1e-5
    assert torch.equal(m, w_m) or _rel(m, w_m) <= 1e-6
    if case == "empty_tiles":
        assert torch.all(out[128:] == 0) and torch.all(l[128:] == 0)
        assert torch.all(m[128:] == G.NEG_INF)

    big = torch.full((3 * rows, heads, o), float("nan"), dtype=dtype,
                     device=cuda)
    res, m2, l2 = G.gat_fwd(*args, out=big[rows:2 * rows])
    torch.cuda.synchronize()
    assert res.data_ptr() == big[rows].data_ptr()
    assert torch.equal(big[rows:2 * rows], out)
    assert torch.equal(m2, m) and torch.equal(l2, l)
    assert torch.isnan(big[:rows].float()).all()
    assert torch.isnan(big[2 * rows:].float()).all()


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


# --- K2: the split dedup SpMM; K1 per chunk -------------------------------


def _split_edges(kind, rng):
    """(senders, receivers, n, threshold) of a mixed, an all-remote and an
    all-direct split layout: hub receivers fed from one source block
    give dense (tile, block) pairs, a random scatter the sparse rest."""
    n = 3000
    hub_r = np.repeat(rng.integers(0, n, 20), 30)
    hub_s = rng.integers(0, 1024, len(hub_r))
    s = np.concatenate([hub_s, rng.integers(0, n, 4000)])
    r = np.concatenate([hub_r, rng.integers(0, n, 4000)])
    threshold = {"mixed": 8, "all_remote": 10 ** 9, "all_direct": 1}[kind]
    return s, r, n, threshold


@pytest.mark.parametrize("kind", ["mixed", "all_remote", "all_direct"]
                         + W_EDITS)
@pytest.mark.parametrize("tn,cu", [(64, 1024), (64, 512), (128, 1024),
                                   (128, 512)])
@pytest.mark.parametrize("dtype,f", [(torch.float32, 100),
                                     (torch.bfloat16, 100),
                                     (torch.float32, 1), (torch.float32, 37),
                                     (torch.float32, 64),
                                     (torch.float32, 129),
                                     (torch.float32, 602)])
def test_split_kernel_matches_plain(cuda, kind, tn, cu, dtype, f):
    """K2 once per chunk against its plain version on the same inputs:
    1e-5 relative to the plain result's max in fp32, 1e-2 in bf16; in
    fp32 on unedited layouts also against the dense product; two launches
    give the same bits.  x's rows are not padded, so the last direct
    block reads past N.  The count edits hit chunk 0's first direct job
    (mixed layout)."""
    from gist_tpu_torch.graph import _build_dedup_split_chunked
    from gist_tpu_torch.ops import split_spmm as K2
    rng = np.random.default_rng(5)
    s, r, n, threshold = _split_edges(
        "mixed" if kind in W_EDITS else kind, rng)
    t = _build_dedup_split_chunked(s, r, n, tile_rows=tn, cu=cu,
                                   threshold=threshold, chunk_rows=1024)
    direct = int(t.is_dir.sum())
    assert {"mixed": direct > 0, "all_remote": direct == 0,
            "all_direct": direct == int(t.job_offsets[:, -1].sum())}.get(
                kind, direct > 0)
    # chunks are sized by remote rows: an all-direct layout has one
    assert t.n_chunks > 1 or kind == "all_direct"
    if kind in W_EDITS:
        jobs = int(t.job_offsets[0, -1])
        job = int(np.flatnonzero(t.is_dir[0, :jobs].numpy() == 1)[0])
        _edit_counts(t.w_blocks[0], job, kind)
    tc = t.to(cuda)
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    xp = x.to(dtype).to(cuda)[tc.perm.long()].contiguous()
    before = K2.launches
    for c in range(tc.n_chunks):
        lay = (tc.job_offsets[c], tc.dir_blk[c], tc.rem_blk[c], tc.is_dir[c],
               tc.w_blocks[c], tc.u_senders[c])
        got = K2.split_spmm(*lay, xp)
        torch.cuda.synchronize()
        assert torch.equal(got, K2.split_spmm(*lay, xp))
        want = K2.split_spmm_reference(*lay, xp)
        assert got.dtype == dtype and got.shape == want.shape
        err = _rel(got, want)
        assert err <= (1e-5 if dtype == torch.float32 else 1e-2), err
    assert K2.launches == before + 2 * tc.n_chunks
    if dtype == torch.float32 and kind not in W_EDITS:
        out = K.run_dedup_chunked(tc, x.to(cuda), n)
        oracle = _dense(s, r, n) @ x.double().numpy()
        np.testing.assert_allclose(out.cpu().numpy(), oracle, rtol=1e-5,
                                   atol=1e-4)


def test_split_aggregate_grad_runs_kernel(cuda):
    """``aggregate`` on a graph with the split layout pair: K2 per chunk
    forward and on the transpose layout backward, against the segment
    path."""
    from gist_tpu_torch.graph import _build_dedup_split_chunked
    from gist_tpu_torch.ops import split_spmm as K2
    rng = np.random.default_rng(6)
    s, r, n, threshold = _split_edges("mixed", rng)
    g = graph_from_edges(s, r, n)
    m = g.n_edges
    kw = dict(threshold=threshold, chunk_rows=4096)
    g = g.replace(
        dedup_c=_build_dedup_split_chunked(g.senders[:m].numpy(),
                                           g.receivers[:m].numpy(), n, **kw),
        dedup_c_t=_build_dedup_split_chunked(g.t_senders[:m].numpy(),
                                             g.t_receivers[:m].numpy(), n,
                                             **kw)).to(cuda)
    x0 = torch.from_numpy(rng.standard_normal((n, 48)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n, 48)).astype(np.float32))
    w = w.to(cuda)
    x = x0.to(cuda).requires_grad_(True)
    before = K2.launches
    out = aggregate(g, x)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    assert K2.launches == before + g.dedup_c.n_chunks + g.dedup_c_t.n_chunks
    xs = x0.to(cuda).requires_grad_(True)
    want = spmm_segment(g, xs)
    (want * w).sum().backward()
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(x.grad, xs.grad, rtol=1e-5, atol=1e-4)


def test_chunked_runner_matches_flat_kernel(cuda):
    """K1 once per chunk (permuted rows, one output buffer) against one
    flat K1 launch on the same graph, forward and backward."""
    rng = np.random.default_rng(7)
    n = 3000
    s, r = rng.integers(0, n, 40000), rng.integers(0, n, 40000)
    g = graph_from_edges(s, r, n)
    gc = g.with_tiles(mode="dedup-chunked", chunk_rows=8192).to(cuda)
    gf = g.with_tiles().to(cuda)
    assert gc.dedup_c.n_chunks > 2 and gc.dedup_c_t.n_chunks > 2
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        x0 = torch.from_numpy(rng.standard_normal((n, 96)).astype(
            np.float32)).to(dtype)
        before = K.launches
        xc = x0.to(cuda).requires_grad_(True)
        out = aggregate(gc, xc)
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        assert K.launches == before + gc.dedup_c.n_chunks \
            + gc.dedup_c_t.n_chunks
        xf = x0.to(cuda).requires_grad_(True)
        want = aggregate(gf, xf)
        want.float().square().sum().backward()
        assert _rel(out, want) <= tol and _rel(xc.grad, xf.grad) <= tol


def test_split_kernel_raises_instead_of_falling_back(cuda):
    from gist_tpu_torch.graph import _build_dedup_split_chunked
    from gist_tpu_torch.ops import split_spmm as K2
    rng = np.random.default_rng(8)
    s, r, n, _ = _split_edges("mixed", rng)
    x = torch.ones((n, 8), device=cuda)
    for tn, dtype in ((32, torch.float32), (64, torch.float64)):
        t = _build_dedup_split_chunked(s, r, n, tile_rows=tn,
                                       threshold=8).to(cuda)
        lay = (t.job_offsets[0], t.dir_blk[0], t.rem_blk[0], t.is_dir[0],
               t.w_blocks[0], t.u_senders[0])
        with pytest.raises(ValueError if tn == 32 else TypeError):
            K2.split_spmm(*lay, x.to(dtype))


# --- K3, K7-K9: the v1 gather layout ----------------------------------------


def _v1_graph(case, rng):
    """A graph with the linked v1 pair, each layout padded past
    ``tile_offsets[-1]`` (as ``pad_tiled_csr`` buckets them)."""
    from gist_tpu_torch.graph import pad_tiled_csr
    s, r, n = _edges(case, rng)
    # a hub row whose slots span more than two 1024-slot chunks
    s = np.concatenate([s, rng.integers(0, n, 2500)])
    r = np.concatenate([r, np.full(2500, 3)])
    g = graph_from_edges(s, r, n, tiles=True, tile_mode="gather")
    return g.replace(**{k: pad_tiled_csr(getattr(g, k),
                                         getattr(g, k).senders.shape[0] + 2048,
                                         getattr(g, k).max_chunks + 2)
                        for k in ("tiled", "tiled_t")}), n


V1_CASES = ["several_tiles", "empty_tiles", "multigraph"]


# K3's widths: narrow rows that fill groups of 8 or 16 lanes (1, 7, 16,
# 41, 47, 63), the edges of those plans (64, 65), one warp over 256
# columns and several block columns (602)
K3_WIDTHS = [(torch.float32, f) for f in (1, 7, 16, 41, 47, 63, 64, 65, 256,
                                          602)] + \
    [(torch.bfloat16, 41), (torch.bfloat16, 256)]


@pytest.mark.parametrize("case", V1_CASES)
@pytest.mark.parametrize("dtype,f", K3_WIDTHS)
def test_tiled_spmm_matches_plain(cuda, case, dtype, f):
    """K3 forward (``tiled``) and transpose (``tiled_t``) with its chosen
    plan against its plain walk: 1e-5 relative to the plain result's max
    in fp32, 1e-2 in bf16; in fp32 also against the dense product; two
    launches give the same bits (no atomics)."""
    from gist_tpu_torch.ops import tiled_spmm as K3
    rng = np.random.default_rng(0)
    g, n = _v1_graph(case, rng)
    gc = g.to(cuda)
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    x = x.to(dtype).to(cuda)
    for t, (snd, rcv) in ((gc.tiled, (g.senders, g.receivers)),
                          (gc.tiled_t, (g.receivers, g.senders))):
        before = K3.launches
        got = K3.tiled_spmm(t, x)
        torch.cuda.synchronize()
        assert K3.launches == before + 1
        assert torch.equal(got, K3.tiled_spmm(t, x))
        want = K3.tiled_spmm_reference(t, x)
        assert got.dtype == dtype and got.shape == want.shape
        err = _rel(got, want)
        assert err <= (1e-5 if dtype == torch.float32 else 1e-2), err
        if dtype == torch.float32:
            e = g.n_edges
            oracle = _dense(snd[:e].numpy(), rcv[:e].numpy(), n) @ \
                x.double().cpu().numpy()
            # the hub row sums 2500 terms in fp32: hold it relative to
            # the output's max, as against the plain walk
            assert _rel(got[:n].cpu().double(),
                        torch.from_numpy(oracle)) <= 1e-5
        if case == "empty_tiles" and t is gc.tiled:
            assert torch.all(got[100:] == 0)


@pytest.mark.parametrize("case", V1_CASES)
@pytest.mark.parametrize("f,vec", [(41, 1), (47, 1), (256, 4), (100, 2)])
@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("group", [8, 16])
def test_tiled_spmm_plans_match_plain(cuda, case, f, vec, rows, group):
    """Both K3 modes with groups of 8 and 16 lanes, each lane holding the
    fewest vectors that cover F (the plans a measurement compares),
    against the plain walk at 1e-5, bitwise equal over two launches; a
    plan without an instance raises."""
    from gist_tpu_torch.ops import tiled_spmm as K3
    rng = np.random.default_rng(0)
    g, n = _v1_graph(case, rng)
    gc = g.to(cuda)
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    x = x.to(cuda)
    plan = K3.Plan(rows, group, min(-(-f // (group * vec)),
                                    K3.MAX_ACC // vec), vec)
    with pytest.raises(RuntimeError):
        K3.run_plan(gc.tiled, x, plan._replace(group=32))
    for t in (gc.tiled, gc.tiled_t):
        got = K3.run_plan(t, x, plan)
        torch.cuda.synchronize()
        assert torch.equal(got, K3.run_plan(t, x, plan))
        assert _rel(got, K3.tiled_spmm_reference(t, x)) <= 1e-5


def test_tiled_aggregate_grad_and_missing_transpose(cuda):
    """``aggregate`` on a v1 graph on the card: K3 forward and on
    ``tiled_t`` backward, against the segment path; without ``tiled_t``
    the backward raises."""
    from gist_tpu_torch.ops import tiled_spmm as K3
    from gist_tpu_torch.ops.spmm import resolve_backend
    rng = np.random.default_rng(1)
    s, r, n = _edges("several_tiles", rng)
    g = graph_from_edges(s, r, n, tiles=True, tile_mode="gather").to(cuda)
    assert resolve_backend(g) == "dedup" and g.dedup is None
    x0 = torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32))
    w = w.to(cuda)
    x = x0.to(cuda).requires_grad_(True)
    before = K3.launches
    out = aggregate(g, x)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    assert K3.launches == before + 2
    xs = x0.to(cuda).requires_grad_(True)
    want = spmm_segment(g, xs)
    (want * w).sum().backward()
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(x.grad, xs.grad, rtol=1e-5, atol=1e-4)
    fwd_only = g.replace(tiled_t=None)
    with pytest.raises(NotImplementedError):
        aggregate(fwd_only, x0.to(cuda).requires_grad_(True)).sum() \
            .backward()
    with pytest.raises(TypeError):
        aggregate(g, x0.to(cuda).double())


# K7's and K8's widths: one column, narrow odd rows (37, 41, 47), a row
# of two lane groups (130), one and several block columns or chunks
# (256, 257, 512, 602, 1024), and bf16
GAT_TILED_WIDTHS = [(torch.float32, d) for d in (1, 37, 41, 47, 130, 256,
                                                 257, 512, 602, 1024)] + \
    [(torch.bfloat16, 64), (torch.bfloat16, 512)]
GAT_TILED_CASES = V1_CASES + ["hub"]


def _gat_tiled_inputs(case, d, dtype, cuda, seed=0):
    rng = np.random.default_rng(seed)
    g, n = _v1_graph(case, rng)

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(cuda)
    return g, g.to(cuda), t(n, d).to(dtype), t(n), t(n), t(n, d)


@pytest.mark.parametrize("case", GAT_TILED_CASES)
@pytest.mark.parametrize("dtype,d", GAT_TILED_WIDTHS)
def test_gat_tiled_kernels_match_plain(cuda, case, dtype, d):
    """K7, then K8 and K9 on the forward's m and l, each with its chosen
    plan against its plain walk on the same inputs: 1e-5 relative to the
    plain result's max in fp32 (every kernel sums each row in a fixed
    order, no atomics), 1e-2 in bf16; m is the exact max; empty rows give
    out 0, m -1e30, l 0; outputs land in NaN-filled memory, so an
    unwritten element shows; two launches give the same bits."""
    from gist_tpu_torch.ops import gat_tiled as GT
    g, gc, z, src, dst, gg = _gat_tiled_inputs(case, d, dtype, cuda)
    rows = gc.tiled.num_tiles * gc.tiled.tile_rows
    before = (GT.launches_fwd, GT.launches_b1, GT.launches_b2)
    _nan_blocks(cuda, ((rows, d), dtype), ((rows,), torch.float32))
    out, m, l = GT.gat_tiled_fwd(gc.tiled, z, src, dst, 0.2)
    torch.cuda.synchronize()
    want = GT.gat_tiled_fwd_reference(gc.tiled, z, src, dst, 0.2)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    assert _rel(out, want[0]) <= tol
    assert torch.equal(m, want[1])
    assert _rel(l, want[2]) <= 1e-5
    again = GT.gat_tiled_fwd(gc.tiled, z, src, dst, 0.2)
    assert all(torch.equal(a, b) for a, b in zip((out, m, l), again))
    empty = torch.from_numpy(np.bincount(
        g.receivers[:g.n_edges].numpy(), minlength=l.shape[0]) == 0).to(cuda)
    assert torch.all(l[empty] == 0) and torch.all(m[empty] == -1e30)
    assert torch.all(out[empty] == 0)
    _nan_blocks(cuda, ((rows,), torch.float32))
    ds, ddst = GT.gat_tiled_bwd_b1(gc.tiled, z, src, dst, m, l, gg, 0.2)
    torch.cuda.synchronize()
    ds_w, ddst_w = GT.gat_tiled_bwd_b1_reference(gc.tiled, z, src, dst, m, l,
                                                 gg, 0.2)
    assert torch.isfinite(ds).all() and torch.isfinite(ddst).all()
    assert _rel(ds, ds_w) <= tol and _rel(ddst, ddst_w) <= tol
    again = GT.gat_tiled_bwd_b1(gc.tiled, z, src, dst, m, l, gg, 0.2)
    assert torch.equal(ds, again[0]) and torch.equal(ddst, again[1])
    dz, dsrc = GT.gat_tiled_bwd_b2(gc.tiled_t, ds, gg, src, dst, m, l, 0.2,
                                   dtype)
    torch.cuda.synchronize()
    dz_w, dsrc_w = GT.gat_tiled_bwd_b2_reference(gc.tiled_t, ds, gg, src,
                                                 dst, m, l, 0.2, dtype)
    assert dz.dtype == dtype
    assert _rel(dz, dz_w) <= tol and _rel(dsrc, dsrc_w) <= tol
    assert (GT.launches_fwd, GT.launches_b1, GT.launches_b2) == (
        before[0] + 2, before[1] + 2, before[2] + 1)


@pytest.mark.parametrize("case", GAT_TILED_CASES)
@pytest.mark.parametrize("d,vec", [(41, 1), (47, 1), (130, 2), (512, 4)])
def test_gat_tiled_plans_match_plain(cuda, case, d, vec):
    """Every plan of K7's and K8's plan spaces (both modes, groups of 8
    and 16 lanes, each per-lane count up to the fewest that cover D)
    against the plain walks in fp32 at 1e-5 (m exact), each bitwise equal
    over two launches; a plan without an instance raises."""
    from gist_tpu_torch.ops import gat_tiled as GT
    _, gc, z, src, dst, gg = _gat_tiled_inputs(case, d, torch.float32, cuda)
    t = gc.tiled
    out_w, m_w, l_w = GT.gat_tiled_fwd_reference(t, z, src, dst, 0.2)
    ds_w, ddst_w = GT.gat_tiled_bwd_b1_reference(t, z, src, dst, m_w, l_w,
                                                 gg, 0.2)
    with pytest.raises(RuntimeError):
        GT.run_fwd_plan(t, z, src, dst, 0.2, GT.Plan(False, 32, 1, vec))
    with pytest.raises(RuntimeError):
        GT.run_b1_plan(t, z, src, dst, m_w, l_w, gg, 0.2,
                       GT.Plan(False, 16, 5, vec))

    def check_fwd(run):
        got = run()
        torch.cuda.synchronize()
        assert _rel(got[0], out_w) <= 1e-5 and _rel(got[2], l_w) <= 1e-5
        assert torch.equal(got[1], m_w)
        assert all(torch.equal(a, b) for a, b in zip(got, run()))
    fwd = GT.plan_space(d, vec, GT.FWD_MAX)
    assert GT.fwd_plan(d, vec) in fwd
    for plan in fwd:
        check_fwd(lambda: GT.run_fwd_plan(t, z, src, dst, 0.2, plan))
    b1 = GT.plan_space(d, vec, GT.B1_MAX)
    assert GT.b1_plan(d, vec) in b1
    for plan in b1:
        ds, ddst = GT.run_b1_plan(t, z, src, dst, m_w, l_w, gg, 0.2, plan)
        torch.cuda.synchronize()
        assert _rel(ds, ds_w) <= 1e-5 and _rel(ddst, ddst_w) <= 1e-5
        again = GT.run_b1_plan(t, z, src, dst, m_w, l_w, gg, 0.2, plan)
        assert torch.equal(ds, again[0]) and torch.equal(ddst, again[1])


@pytest.mark.parametrize("case", GAT_TILED_CASES)
@pytest.mark.parametrize("dtype,d,vec", [
    (torch.float32, 41, 1), (torch.float32, 512, 4),
    (torch.bfloat16, 41, 1), (torch.bfloat16, 512, 4)])
def test_gat_tiled_b2_plans_match_plain(cuda, case, dtype, d, vec):
    """Every plan of K9's plan space (both modes, groups of 8 and 16
    lanes, each per-lane count up to the fewest that cover D, at most
    B2_MAX accumulators) against the plain walk on the plain forward's m
    and l and the plain B1's ds: 1e-5 relative to the plain result's max
    with dz in fp32, 1e-2 in bf16; dz and dsrc land in NaN-filled memory;
    two launches give the same bits; rows of the transpose layout without
    slots give dz 0 and dsrc 0; a plan without an instance raises."""
    from gist_tpu_torch.ops import gat_tiled as GT
    g, gc, z, src, dst, gg = _gat_tiled_inputs(case, d, torch.float32, cuda)
    tt = gc.tiled_t
    _, m, l = GT.gat_tiled_fwd_reference(gc.tiled, z, src, dst, 0.2)
    ds, _ = GT.gat_tiled_bwd_b1_reference(gc.tiled, z, src, dst, m, l, gg,
                                          0.2)
    args = (tt, ds, gg, src, dst, m, l, 0.2)
    dz_w, dsrc_w = GT.gat_tiled_bwd_b2_reference(*args, dtype)
    rows = tt.num_tiles * tt.tile_rows
    empty = torch.from_numpy(np.bincount(
        g.senders[:g.n_edges].numpy(), minlength=rows) == 0).to(cuda)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    with pytest.raises(RuntimeError):
        GT.run_b2_plan(*args, GT.Plan(False, 32, 1, vec), dtype)
    space = GT.plan_space(d, vec, GT.B2_MAX)
    assert GT.b2_plan(d, vec) in space
    for plan in space:
        _nan_blocks(cuda, ((rows, d), dtype), ((rows,), torch.float32))
        before = GT.launches_b2
        dz, dsrc = GT.run_b2_plan(*args, plan, dtype)
        torch.cuda.synchronize()
        assert GT.launches_b2 == before + 1
        assert dz.dtype == dtype and torch.isfinite(dz.float()).all()
        assert torch.isfinite(dsrc).all()
        assert _rel(dz, dz_w) <= tol and _rel(dsrc, dsrc_w) <= 1e-5, plan
        assert torch.all(dz[empty] == 0) and torch.all(dsrc[empty] == 0)
        again = GT.run_b2_plan(*args, plan, dtype)
        assert torch.equal(dz, again[0]) and torch.equal(dsrc, again[1])


def test_gat_tiled_attention_grad_on_card(cuda):
    """The autograd path on a v1 graph: one K7 launch forward, one K8 and
    one K9 backward, against the segment composite."""
    from gist_tpu_torch.ops import gat_tiled as GT
    from gist_tpu_torch.ops.segment import gat_attention_segment
    rng = np.random.default_rng(3)
    s, r, n = _edges("several_tiles", rng)
    g = graph_from_edges(s, r, n, tiles=True, tile_mode="gather").to(cuda)

    def leaves():
        gen = np.random.default_rng(4)
        return [torch.from_numpy(gen.standard_normal(shape).astype(
            np.float32)).to(cuda).requires_grad_(True)
            for shape in ((n, 24), (n,), (n,))]
    w = torch.from_numpy(rng.standard_normal((n, 24)).astype(
        np.float32)).to(cuda)
    before = (GT.launches_fwd, GT.launches_b1, GT.launches_b2)
    kl = leaves()
    out = GT.gat_attention_tiled(g, *kl, 0.01)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    assert (GT.launches_fwd - before[0], GT.launches_b1 - before[1],
            GT.launches_b2 - before[2]) == (1, 1, 1)
    sl = leaves()
    ref = gat_attention_segment(g, *sl, 0.01)
    (ref * w).sum().backward()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    for a, b in zip(kl, sl):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4)
    with pytest.raises(TypeError):
        GT.gat_tiled_fwd(g.tiled, kl[0].detach().double(), kl[1].detach(),
                         kl[2].detach(), 0.01)


def test_checkpoint_cuda_generator_round_trip(cuda, tmp_path):
    """A CUDA generator's state survives a checkpoint bitwise, and it
    restores only into a CUDA generator."""
    from gist_tpu_torch.train import checkpoint as C
    gen = torch.Generator(device=cuda).manual_seed(5)
    torch.rand(1000, generator=gen, device=cuda)
    C.save_checkpoint(str(tmp_path / "round_0"),
                      {"drop_gen": C.generator_state(gen)})
    saved = C.load_checkpoint(str(tmp_path / "round_0"))["drop_gen"]
    assert saved["device"] == "cuda"
    fresh = torch.Generator(device=cuda).manual_seed(0)
    C.restore_generator(fresh, saved)
    assert torch.equal(torch.rand(4096, generator=fresh, device=cuda),
                       torch.rand(4096, generator=gen, device=cuda))
    with pytest.raises(ValueError, match="'cuda' generator"):
        C.restore_generator(torch.Generator(), saved)
    with pytest.raises(ValueError, match="'cpu' generator"):
        C.restore_generator(torch.Generator(device=cuda),
                            C.generator_state(torch.Generator()))


def test_ultrawide_resume_on_card(cuda, tmp_path, monkeypatch):
    """Cut after round 1 and resumed to round 3 on the card: the
    resumed call's record (the whole run's) equals the uninterrupted
    run's, dropout masks drawn on the card.
    Every batch carries the dedup layout, so the steps run K1; the same
    run on the segment path (S1) is
    ``test_ultrawide_resume_on_card_segment_path``."""
    from gist_tpu_torch import sampler
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.models.sage import SAGEConfig
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.ist_ultrawide import train_ist_ultrawide
    monkeypatch.setattr(sampler, "TILES_MIN_EDGES", 0)

    def run(n_epochs, ck=None):
        ds = load_dataset("synth-tiny")
        tc = TrainConfig(lr=3e-2, weight_decay=0.0, n_epochs=n_epochs,
                         num_subnet=2, iter_per_site=2)
        return train_ist_ultrawide(
            ds, SAGEConfig(ds.in_feats, 16, ds.n_classes, dropout=0.3), tc,
            psize=4, batch_size=2, eval_on_cpu=False, checkpoint_dir=ck,
            verbose=False, device="cuda")
    K.launches = 0
    full = run(8)
    assert K.launches > 0
    cut = run(4, str(tmp_path))
    resumed = run(8, str(tmp_path))
    # the resumed call returns the whole run: the cut call's rounds first
    assert resumed["losses"][:len(cut["losses"])] == cut["losses"]
    assert resumed["losses"] == full["losses"]
    assert resumed["val_accs"] == full["val_accs"]


def test_cluster_gcn_use_pp_through_kernel(cuda, monkeypatch):
    """A ``use_pp`` Cluster-GCN epoch on the card: every batch carries a
    layout, the first layer skips its aggregation, so a SAGE stack of L
    weight layers launches K1 2L - 2 times a step (L - 1 forward, L - 1
    transpose)."""
    from gist_tpu_torch import sampler
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.models.sage import SAGEConfig
    from gist_tpu_torch.train.cluster import train_cluster_gcn
    from gist_tpu_torch.train.common import TrainConfig
    monkeypatch.setattr(sampler, "TILES_MIN_EDGES", 0)
    ds = load_dataset("synth-tiny")
    cfg = SAGEConfig(ds.in_feats, 16, ds.n_classes, n_layers=2, dropout=0.2,
                     use_pp=True)
    K.launches = 0
    r = train_cluster_gcn(ds, cfg, TrainConfig(n_epochs=1), psize=4,
                          batch_size=2, use_pp=True, verbose=False,
                          device="cuda")
    torch.cuda.synchronize()
    n_layers = cfg.n_layers + 1
    assert K.launches == (2 * n_layers - 2) * 2   # 2 batches an epoch
    assert np.isfinite(r["losses"]).all()


def test_lsgd_round_through_kernel_matches_plain(cuda, tmp_path,
                                                 monkeypatch):
    """Two local-SGD rounds (K=2 workers, their own batches, every leaf
    averaged) through K1 on the card and through its plain walk on the
    CPU, from the same initial parameters, dropout 0: the merged
    parameters agree norm-wise per leaf within 1e-3 (ReLU models,
    PERF.md §2), the losses within 1e-3 relative."""
    from gist_tpu_torch import sampler
    from gist_tpu_torch.convert import params_to_numpy
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.models import sage
    from gist_tpu_torch.ops import spmm
    from gist_tpu_torch.train.checkpoint import (latest_round_dir,
                                                 load_checkpoint)
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.ist_cluster import train_ist_cluster
    monkeypatch.setattr(sampler, "TILES_MIN_EDGES", 0)
    cfg = sage.SAGEConfig(32, 16, 4, n_layers=2, dropout=0.0)
    init = params_to_numpy(sage.init(torch.Generator().manual_seed(0), cfg))
    tc = TrainConfig(n_epochs=4, num_subnet=2, iter_per_site=2)
    out = {}
    for device, backend in (("cuda", "auto"), ("cpu", "dedup")):
        monkeypatch.setattr(spmm, "_DEFAULT_BACKEND", backend)
        ck = str(tmp_path / device)
        K.launches = 0
        r = train_ist_cluster(load_dataset("synth-tiny"), cfg, tc, psize=4,
                              batch_size=2, lsgd=True, init_params=init,
                              checkpoint_dir=ck, verbose=False,
                              device=device)
        if device == "cuda":
            torch.cuda.synchronize()
            # 2 rounds x 2 workers x 2 steps, 5 launches a step
            assert K.launches == 2 * 2 * 2 * 5
        out[device] = (r, load_checkpoint(latest_round_dir(ck))["params"])
    (rc, pc), (rp, pp) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(rc["losses"], rp["losses"], rtol=1e-3)
    for lc, lp in zip(pc["layers"], pp["layers"]):
        for k in lc:
            a, b = lc[k].float().cpu(), lp[k].float()
            assert float((a - b).norm() / b.norm()) <= 1e-3, k


# --- CUDA-graph capture: the epoch scans --------------------------------------


def _replayed(fn):
    """(the outputs of one replay of ``fn`` captured into a CUDA graph,
    the capture) after the outputs were overwritten with NaN, so that
    the replay must write every element."""
    from gist_tpu_torch.train.capture import Captured
    held = {}

    def call():
        out = fn()
        held["out"] = out if isinstance(out, tuple) else (out,)
    run = Captured(call)
    for t in held["out"]:
        t.fill_(float("nan"))
    run.replay()
    torch.cuda.synchronize()
    return held["out"], run


@pytest.mark.parametrize("f", [41, 256])
def test_k1_and_k3_replays_match_eager(cuda, f):
    """K1 on a flat dedup layout and K3 on a v1 layout, each captured
    once and replayed on new inputs copied into the captured x: the
    replay's output equals an eager launch's bit for bit (both sum in a
    fixed order) and the plain walk's within 1e-5 relative."""
    from gist_tpu_torch.ops import tiled_spmm as K3
    rng = np.random.default_rng(1)
    s, r, n = _edges("multi_job", rng)
    d = _build_dedup_tiles(s, r, n, reorder=False)
    jo, w, u = (t.to(cuda) for t in (d.job_offsets, d.w_blocks, d.u_senders))
    g, n3 = _v1_graph("several_tiles", rng)
    t = g.to(cuda).tiled
    for launch, plain, n_rows in (
            (lambda x: K.dedup_spmm(jo, w, u, x),
             lambda x: K.dedup_spmm_reference(jo, w, u, x), n),
            (lambda x: K3.tiled_spmm(t, x),
             lambda x: K3.tiled_spmm_reference(t, x), n3)):
        def rand():
            return torch.from_numpy(rng.standard_normal(
                (n_rows, f)).astype(np.float32)).to(cuda)
        x = rand()
        (got,), run = _replayed(lambda: launch(x))
        assert torch.equal(got, launch(x))
        x.copy_(rand())
        run.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, launch(x))
        assert _rel(got, plain(x)) <= 1e-5


def test_cluster_scan_captured_matches_loop(cuda, monkeypatch):
    """``train_cluster_gcn(scan_batches=True)`` on the card, K1 on every
    batch: the epoch's steps captured per bucket and replayed once an
    epoch give the loop's losses within 1e-5 relative; K1's counter
    counts the warm-up's launches and the captured ones (5 a step, a
    SAGE stack of 3 weight layers), and the replays one an epoch.  With
    dropout, drawn from the generator registered with each capture, two
    seeded runs agree."""
    from gist_tpu_torch import sampler
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.models.sage import SAGEConfig
    from gist_tpu_torch.train import capture
    from gist_tpu_torch.train.cluster import train_cluster_gcn
    from gist_tpu_torch.train.common import TrainConfig
    monkeypatch.setattr(sampler, "TILES_MIN_EDGES", 0)

    def run(scan, dropout=0.0):
        ds = load_dataset("synth-tiny")
        cfg = SAGEConfig(ds.in_feats, 16, ds.n_classes, n_layers=2,
                         dropout=dropout)
        return train_cluster_gcn(ds, cfg, TrainConfig(n_epochs=4), psize=6,
                                 batch_size=2, scan_batches=scan,
                                 verbose=False, device="cuda")
    K.launches = 0
    loop = run(False)
    assert K.launches == 4 * 3 * 5
    capture.reset_stats()
    K.launches = 0
    scan = run(True)
    c = capture.stats["captures"]
    assert capture.stats["replays"] == 4 and 1 <= c <= 4
    assert K.launches == c * (1 + 3) * 5
    np.testing.assert_allclose(scan["losses"], loop["losses"], rtol=1e-5)
    a, b = run(True, 0.3), run(True, 0.3)
    assert a["losses"] == b["losses"] != scan["losses"]
    assert np.isfinite(a["losses"]).all()


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_full_graph_scan_on_card_matches_loop(cuda, model):
    """``train_full_graph(scan_epochs=2)`` on a v1 graph (K3 for GCN,
    K7-K9 for GAT) with the LR schedule: the replayed epochs give the
    loop's losses within 1e-4 relative and its accuracies."""
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.models import gat, gcn
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.full_graph import train_full_graph
    ds = load_dataset("synth-tiny", self_loop=True)
    graph = graph_from_edges(ds.senders, ds.receivers, ds.n_nodes,
                             tiles=True, tile_mode="gather")
    mod = gcn if model == "gcn" else gat
    cfg = gcn.GCNConfig(ds.in_feats, 16, ds.n_classes, dropout=0.0) \
        if model == "gcn" else gat.GATConfig(ds.in_feats, 16, ds.n_classes)
    tc = TrainConfig(n_epochs=5, lr_schedule=True)
    loop, scan = (train_full_graph(ds, cfg, tc, model=mod, graph=graph,
                                   scan_epochs=k, verbose=False)
                  for k in (0, 2))
    np.testing.assert_allclose(scan["losses"], loop["losses"], rtol=1e-4)
    assert scan["val_accs"] == loop["val_accs"]


def test_sharded_aggregate_through_k1_on_one_rank(cuda, tmp_path):
    """The sharded aggregation on the card in a one-rank group: the
    interior dedup layouts are built (``interior_tiles=None`` with a
    card), K1 runs once forward and once on the transpose layout, and the
    result and gradient match the flat segment aggregation."""
    import torch.distributed as dist

    from gist_tpu_torch.parallel import (build_sharded_graph, comm,
                                         sharded_aggregate)
    from gist_tpu_torch.parallel.graph_shard import unshard

    rng = np.random.default_rng(0)
    n = 2000
    s, r = rng.integers(0, n, 30000), rng.integers(0, n, 30000)
    x = torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = comm.make_mesh("cuda", (1,), ("graph",))
        sg = build_sharded_graph(s, r, n, 1)
        assert sg.int_dedup is not None
        perm = sg.node_perm.long()
        xs = torch.zeros((sg.total_rows, 64))
        xs[perm] = x
        ws = torch.zeros_like(xs)
        ws[perm] = w
        xs = xs.to(cuda).requires_grad_(True)
        K.launches = 0
        y = sharded_aggregate(sg, mesh)(xs)
        (y * ws.to(cuda)).sum().backward()
        torch.cuda.synchronize()
        assert K.launches == 2
    finally:
        dist.destroy_process_group()
    g = graph_from_edges(s, r, n)
    want = spmm_segment(g, x)
    want_dx = spmm_segment(g.transpose(), w)
    got = unshard(sg, y.detach().cpu())
    got_dx = unshard(sg, xs.grad.cpu())
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    torch.testing.assert_close(got_dx, want_dx, rtol=1e-5,
                               atol=1e-5 * float(want_dx.abs().max()))


# --- K1 at CU 512, and the trainers' device-independent init -------------


@pytest.mark.parametrize("tn", [64, 128, 256])
@pytest.mark.parametrize("case", ["several_tiles", "multi_job"])
@pytest.mark.parametrize("dtype,f", [(torch.float32, 100),
                                     (torch.float32, 602),
                                     (torch.bfloat16, 100)])
def test_kernel_cu512_matches_plain(cuda, tn, case, dtype, f):
    """K1 on layouts of 512 slots a job (the full-scale SpMM benchmark's
    ``SPMM_CU=512``) against its plain walk: 1e-5 relative to the plain
    result's max in fp32 (1e-2 bf16), two launches bitwise equal; every
    tile's jobs are at least those of the CU-1024 layout."""
    rng = np.random.default_rng(512 + tn)
    s, r, n = _edges(case, rng)
    d = _build_dedup_tiles(s, r, n, tile_rows=tn, cu=512, reorder=False)
    d1024 = _build_dedup_tiles(s, r, n, tile_rows=tn, reorder=False)
    assert tuple(d.w_blocks.shape[1:]) == (tn, 512)
    assert d.w_blocks.shape[0] >= d1024.w_blocks.shape[0]
    d = d.to(cuda)
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    x = x.to(dtype).to(cuda)
    got = K.dedup_spmm(d.job_offsets, d.w_blocks, d.u_senders, x)
    again = K.dedup_spmm(d.job_offsets, d.w_blocks, d.u_senders, x)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = K.dedup_spmm_reference(d.job_offsets, d.w_blocks, d.u_senders,
                                  x)
    assert _rel(got, want) <= (1e-5 if dtype == torch.float32 else 1e-2)


def test_default_init_is_the_same_on_card_and_cpu(cuda, monkeypatch,
                                                  tmp_path):
    """Each single-card trainer (Cluster-GCN, full graph, IST over
    clusters, the IST simulation) and the graft entry draws its default
    params from a CPU generator and moves them to the card, so they equal
    the CPU's bit for bit; dropout generators stay on the card."""
    from gist_tpu_torch import graft_entry
    from gist_tpu_torch.data import synthetic_dataset
    from gist_tpu_torch.ist.simulate import train_ist_simulation
    from gist_tpu_torch.models import gcn, sage
    from gist_tpu_torch.train.cluster import train_cluster_gcn
    from gist_tpu_torch.train.common import TrainConfig, seeded_init
    from gist_tpu_torch.train.full_graph import train_full_graph
    from gist_tpu_torch.train.ist_cluster import train_ist_cluster

    drawn = []
    for model in (sage, gcn):
        def init(generator, cfg, _orig=model.init):
            drawn.append(generator.device.type)
            return _orig(generator, cfg)
        monkeypatch.setattr(model, "init", init)
    ds = synthetic_dataset("synth-tiny")
    scfg = sage.SAGEConfig(ds.in_feats, 16, ds.n_classes, n_layers=2)
    gcfg = gcn.GCNConfig(ds.in_feats, 16, ds.n_classes, n_layers=1)
    tc = TrainConfig(n_epochs=1)
    ist = TrainConfig(n_epochs=2, num_subnet=2, iter_per_site=1)
    runs = {
        "cluster": lambda: train_cluster_gcn(ds, scfg, tc, psize=4,
                                             batch_size=2, device="cuda",
                                             verbose=False),
        "full_graph": lambda: train_full_graph(ds, gcfg, tc, device="cuda",
                                               verbose=False),
        "ist_cluster": lambda: train_ist_cluster(
            ds, scfg, ist, psize=4, batch_size=2, device="cuda",
            verbose=False),
        "ist_simulation": lambda: train_ist_simulation(
            ds, gcfg, ist, device="cuda", verbose=False),
        "graft_entry": lambda: graft_entry.entry("cuda"),
    }
    for name, fn in runs.items():
        drawn.clear()
        fn()
        assert drawn and set(drawn) == {"cpu"}, (name, drawn)
    for model, cfg in ((sage, scfg), (gcn, gcfg)):
        on_card = seeded_init(model, cfg, 3, cuda)
        on_cpu = seeded_init(model, cfg, 3, "cpu")
        for lc, lh in zip(on_card["layers"], on_cpu["layers"]):
            for k in lh:
                assert lc[k].device.type == "cuda"
                assert torch.equal(lc[k].cpu(), lh[k])


# --- S1: the segment path's CSR row walk ----------------------------------


def _s1_rel_bar(dtype):
    return 1e-2 if dtype == torch.bfloat16 else 1e-5


@pytest.mark.parametrize("case", CASES + ["hub"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("f", [1, 41, 100, 256, 602])
def test_segment_csr_matches_plain(cuda, case, dtype, f):
    """S1 over a graph's receivers and over its transpose view (the
    aggregation's forward and backward) against its plain version (gather
    and ``index_add_``): 1e-5 relative to the plain result's max in fp32
    and fp64 (the float64 references of the training checks), 1e-2 in
    bf16; two launches give the same bits; rows without edges are 0."""
    from gist_tpu_torch.ops import segment_csr as S
    rng = np.random.default_rng(f)
    s, r, n = _edges(case, rng)
    g = graph_from_edges(s, r, n, pad_to=len(s) + 5).to(cuda)
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    x = x.to(dtype).to(cuda)
    for ptr, idx, deg in ((g.indptr, g.senders, g.in_degrees),
                          (g.t_indptr, g.t_senders, g.out_degrees)):
        got = S.segment_csr(ptr, x, idx)
        again = S.segment_csr(ptr, x, idx)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, again)
        assert _rel(got, S.segment_csr_reference(ptr, x, idx)) \
            <= _s1_rel_bar(dtype)
        assert bool((got[deg == 0] == 0).all())


@pytest.mark.parametrize("heads,d", [(1, 64), (2, 256), (4, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_csr_weighted_and_identity_match_plain(cuda, heads, d,
                                                        dtype):
    """S1 with per-edge weights over heads (the GAT weighted sum, alpha in
    fp32) and with the identity index (per-edge rows, the softmax
    denominators): the plain version's bars, bitwise repeats."""
    from gist_tpu_torch.ops import segment_csr as S
    rng = np.random.default_rng(heads * d)
    s, r, n = _edges("hub", rng)
    g = graph_from_edges(s, r, n).to(cuda)
    z = torch.from_numpy(rng.standard_normal((n, heads, d)).astype(
        np.float32)).to(dtype).to(cuda)
    w = torch.from_numpy(rng.random((g.n_edges_padded, heads)).astype(
        np.float32)).to(cuda)
    m = torch.from_numpy(rng.standard_normal(
        (g.n_edges_padded, heads)).astype(np.float32)).to(dtype).to(cuda)
    for args in ((g.indptr, z, g.senders, w), (g.indptr, m)):
        got = S.segment_csr(*args)
        again = S.segment_csr(*args)
        want = S.segment_csr_reference(*args)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, again)
        assert _rel(got, want) <= _s1_rel_bar(dtype)


S1_DTYPES = [torch.float32, torch.bfloat16, torch.float64]
S1_WIDTHS = [1, 2, 3, 41, 100, 255, 256, 257, 301, 602, 1024]


@pytest.mark.parametrize("dtype", S1_DTYPES)
@pytest.mark.parametrize("f", S1_WIDTHS)
def test_segment_csr_plans_match_plain(cuda, dtype, f):
    """Every plan of S1's plan space (16-byte vectors, realigned where
    the rows are not on 16-byte boundaries, and 8-byte ones where they
    are on 8-byte boundaries), over a graph's receivers and over its
    transpose view, against the plain version (1e-5 relative to its max
    in fp32 and fp64, 1e-2 in bf16) and bit for bit against the chosen
    plan's output and a second launch: every plan sums each row in edge
    order."""
    from gist_tpu_torch.ops import segment_csr as S
    rng = np.random.default_rng(f)
    s, r, n = _edges("hub", rng)
    g = graph_from_edges(s, r, n, pad_to=len(s) + 5).to(cuda)
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    x = x.to(dtype).to(cuda)
    for ptr, idx in ((g.indptr, g.senders), (g.t_indptr, g.t_senders)):
        want = S.segment_csr(ptr, x, idx)
        torch.cuda.synchronize()
        assert _rel(want, S.segment_csr_reference(ptr, x, idx)) \
            <= _s1_rel_bar(dtype)
        item = x.element_size()
        for plan in S.plan_space(f, item, S.row_align(f, item,
                                                      x.data_ptr())):
            got = S.run_plan(ptr, x, idx, None, plan)
            again = S.run_plan(ptr, x, idx, None, plan)
            torch.cuda.synchronize()
            assert torch.equal(got, want) and torch.equal(again, want), plan


@pytest.mark.parametrize("dtype", S1_DTYPES)
@pytest.mark.parametrize("f", [3, 41, 100, 256, 602])
@pytest.mark.parametrize("view", ["row", "element"])
def test_segment_csr_misaligned_views_match_contiguous(cuda, dtype, f,
                                                      view):
    """S1 on a view whose rows start off 16-byte boundaries (``x[1:]`` of
    a larger tensor, or one element into its storage: its 16-byte words
    realigned across lanes) gives the bits of the same values in a fresh
    tensor, forward, transpose and weighted over two heads, its output
    written into memory filled with NaN; and the plain version's bars."""
    from gist_tpu_torch.ops import segment_csr as S
    rng = np.random.default_rng(f + len(view))
    s, r, n = _edges("hub", rng)
    g = graph_from_edges(s, r, n, pad_to=len(s) + 5).to(cuda)
    flat = torch.from_numpy(rng.standard_normal((n + 1) * 2 * f).astype(
        np.float32)).to(dtype).to(cuda)
    start = 2 * f if view == "row" else 1
    x = flat[start:start + n * 2 * f].view(n, 2, f)
    wdt = torch.float64 if dtype == torch.float64 else torch.float32
    w = torch.from_numpy(rng.random((g.n_edges_padded, 2))).to(wdt).to(cuda)
    for args in ((g.indptr, x, g.senders), (g.t_indptr, x, g.t_senders),
                 (g.indptr, x, g.senders, w)):
        want = S.segment_csr(args[0], x.clone(), *args[2:])
        _nan_blocks(cuda, (tuple(want.shape), want.dtype))
        got = S.segment_csr(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert _rel(got, S.segment_csr_reference(*args)) \
            <= _s1_rel_bar(dtype)


def test_segment_functions_backward_match_plain(cuda):
    """The segment path's Functions on the card (S1 forward and
    backward) against the same Functions on the CPU (the plain
    versions), fp32: the aggregation, and the GAT composite's output and
    the gradients of z and both scores, 1e-5; a second backward on the
    card gives the same bits.  (A receiver's score gradient sums terms
    that cancel; the CPU tests hold a hub's against the scale of its
    terms.)"""
    from gist_tpu_torch.ops import segment as SEG
    from gist_tpu_torch.ops import segment_csr as S
    dtype = torch.float32
    rng = np.random.default_rng(7)
    s, r, n = _edges("several_tiles", rng)
    g = graph_from_edges(s, r, n, pad_to=len(s) + 11)
    arrays = [rng.standard_normal((n, 2, 32)), rng.standard_normal((n, 2)),
              rng.standard_normal((n, 2)), rng.standard_normal((n, 64))]
    arrays = [torch.from_numpy(a.astype(np.float32)).to(dtype)
              for a in arrays]
    ct = torch.from_numpy(rng.standard_normal((n, 2, 32)).astype(
        np.float32))
    ct_x = torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32))

    def run(graph, device):
        leaves = [a.to(device).requires_grad_(True) for a in arrays]
        out = SEG.gat_attention_segment(graph, *leaves[:3])
        agg = S.aggregate(graph, leaves[3])
        grads = torch.autograd.grad(
            (out, agg), leaves, (ct.to(device, out.dtype),
                                 ct_x.to(device, agg.dtype)))
        return [t.detach().float().cpu() for t in (out, agg, *grads)]
    S.launches = 0
    card, again = run(g.to(cuda), cuda), run(g.to(cuda), cuda)
    torch.cuda.synchronize()
    assert S.launches > 0
    host = run(g, "cpu")
    for a, b, c in zip(card, again, host):
        assert torch.equal(a, b)
        assert _rel(a, c) <= _s1_rel_bar(dtype)


def test_segment_csr_raises_instead_of_falling_back(cuda):
    from gist_tpu_torch.ops import segment_csr as S
    g = graph_from_edges([0, 1, 2], [1, 2, 0], 3).to(cuda)
    x = torch.ones((3, 4), device=cuda)
    with pytest.raises(TypeError):
        S.segment_csr(g.indptr.long(), x, g.senders)
    with pytest.raises(TypeError):
        S.segment_csr(g.indptr, x.half(), g.senders)
    with pytest.raises(ValueError):
        S.segment_csr(g.indptr, x, g.senders.cpu())


def test_segment_csr_replay_matches_eager(cuda):
    """S1 captured once and replayed on new inputs copied into the
    captured x: the replay equals an eager launch bit for bit, after the
    output was overwritten with NaN."""
    from gist_tpu_torch.ops import segment_csr as S
    rng = np.random.default_rng(3)
    s, r, n = _edges("several_tiles", rng)
    g = graph_from_edges(s, r, n).to(cuda)

    def rand():
        return torch.from_numpy(rng.standard_normal((n, 100)).astype(
            np.float32)).to(cuda)
    x = rand()
    (got,), run = _replayed(lambda: S.segment_csr(g.indptr, x, g.senders))
    assert torch.equal(got, S.segment_csr(g.indptr, x, g.senders))
    x.copy_(rand())
    run.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, S.segment_csr(g.indptr, x, g.senders))


def test_cluster_scan_on_segment_path_launches_s1(cuda):
    """``train_cluster_gcn(scan_batches=True)`` at the default threshold:
    the batches carry no layout, so the captured steps run S1 and no K1;
    the replayed epochs give the loop's losses within 1e-5 relative, and
    two runs of each give the same losses."""
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.models.sage import SAGEConfig
    from gist_tpu_torch.ops import segment_csr as S
    from gist_tpu_torch.train import capture
    from gist_tpu_torch.train.cluster import train_cluster_gcn
    from gist_tpu_torch.train.common import TrainConfig

    def run(scan):
        ds = load_dataset("synth-tiny")
        cfg = SAGEConfig(ds.in_feats, 16, ds.n_classes, n_layers=2,
                         dropout=0.3)
        return train_cluster_gcn(ds, cfg, TrainConfig(n_epochs=3), psize=6,
                                 batch_size=2, scan_batches=scan,
                                 verbose=False, device="cuda")
    K.launches = S.launches = 0
    loop, loop2 = run(False), run(False)
    assert S.launches > 0 and K.launches == 0
    capture.reset_stats()
    S.launches = 0
    scan, scan2 = run(True), run(True)
    assert capture.stats["replays"] == 6 and S.launches > 0
    assert K.launches == 0
    assert loop["losses"] == loop2["losses"]
    assert scan["losses"] == scan2["losses"]
    np.testing.assert_allclose(scan["losses"], loop["losses"], rtol=1e-5)


def test_ultrawide_resume_on_card_segment_path(cuda, tmp_path):
    """``test_ultrawide_resume_on_card`` at the default threshold, where
    the batches carry no layout and every step runs the segment path
    (S1, no K1): the resumed record equals the uninterrupted run's
    exactly."""
    from gist_tpu_torch.data import load_dataset
    from gist_tpu_torch.models.sage import SAGEConfig
    from gist_tpu_torch.ops import segment_csr as S
    from gist_tpu_torch.train.common import TrainConfig
    from gist_tpu_torch.train.ist_ultrawide import train_ist_ultrawide

    def run(n_epochs, ck=None):
        ds = load_dataset("synth-tiny")
        tc = TrainConfig(lr=3e-2, weight_decay=0.0, n_epochs=n_epochs,
                         num_subnet=2, iter_per_site=2)
        return train_ist_ultrawide(
            ds, SAGEConfig(ds.in_feats, 16, ds.n_classes, dropout=0.3), tc,
            psize=4, batch_size=2, eval_on_cpu=False, checkpoint_dir=ck,
            verbose=False, device="cuda")
    K.launches = S.launches = 0
    full = run(8)
    assert S.launches > 0 and K.launches == 0
    cut = run(4, str(tmp_path))
    resumed = run(8, str(tmp_path))
    assert resumed["losses"][:len(cut["losses"])] == cut["losses"]
    assert resumed["losses"] == full["losses"]
    assert resumed["val_accs"] == full["val_accs"]
