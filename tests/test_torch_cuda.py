"""K1 (the dedup SpMM CUDA kernel) against its plain PyTorch version on
the card.  CUDA kernels have no CPU mode, so every test here skips
without a card.  On a machine with one (and without JAX), run:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gist_tpu_torch.graph import (_build_dedup_tiles, graph_from_edges,
                                  pad_dedup_tiles)
from gist_tpu_torch.ops import dedup_spmm as K
from gist_tpu_torch.ops.spmm import aggregate, spmm_segment

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernel has no CPU mode")
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
