"""The chunked dedup attention (K4 once per chunk, the composite
backward) and the ``dedup_c`` route of ``gat.apply`` against the JAX
package (``tests/test_pallas_gat.py``'s chunked cases).

Forward against the interpret-mode Pallas kernel at 5e-3, the JAX tests'
bar (the TPU kernel rounds its probability matrix to bf16), and against
the exact composite at rtol 1e-4 / atol 1e-5; the gradients, which are
the composite's in both packages, at rtol 1e-4 / atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gist_tpu.graph as JG
from conftest import make_random_graph
from gist_tpu.models import gat as jgat
from gist_tpu.ops.pallas_gat import (_xla_reference,
                                     gat_attention_dedup_chunked as jchunked)

import gist_tpu_torch.graph as TG
from gist_tpu_torch.convert import params_from_jax
from gist_tpu_torch.models import gat as tgat
from gist_tpu_torch.ops import gat_dedup as K
from gist_tpu_torch.ops import spmm as TS
from torch_port_helpers import load_jax_partitioner, run_interpret

SLOPE = 0.01
EXACT = dict(rtol=1e-4, atol=1e-5)
KERNEL = dict(rtol=5e-3, atol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _pair(rng, n, e):
    s, r = make_random_graph(rng, n, e)
    gj = JG.graph_from_edges(s, r, n).with_tiles(
        tile_rows=128, mode="dedup-chunked", chunk_rows=1024)
    gt = TG.graph_from_edges(s, r, n).with_tiles(
        tile_rows=128, mode="dedup-chunked", chunk_rows=1024)
    assert gt.dedup_c.n_chunks > 1 and gt.dedup is None
    return gj, gt


def _inputs(rng, n, heads, d):
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((n, heads, d), (n, heads), (n, heads))]


def _j(*arrays):
    return [jnp.array(a, copy=True) for a in arrays]


def test_chunked_attention_forward(rng):
    n, heads, d = 300, 2, 8
    gj, gt = _pair(rng, n, 1500)
    z, a, b = _inputs(rng, n, heads, d)
    exact = np.stack([np.asarray(_xla_reference(
        gj, jnp.asarray(z[:, h]), jnp.asarray(a[:, h]), jnp.asarray(b[:, h]),
        SLOPE)) for h in range(heads)], axis=1)
    before = K.launches_fwd
    got = K.gat_attention_dedup_chunked(
        gt, *map(torch.from_numpy, (z, a, b)), SLOPE).numpy()
    assert K.launches_fwd == before          # CPU tensors: plain walk
    kern = run_interpret(lambda: jchunked(gj, *_j(z, a, b), SLOPE))
    np.testing.assert_allclose(got, kern, **KERNEL)
    np.testing.assert_allclose(got, exact, **EXACT)


def test_chunked_attention_grad(rng):
    n, heads, d = 200, 2, 8
    gj, gt = _pair(rng, n, 900)
    z, a, b = _inputs(rng, n, heads, d)
    w = rng.standard_normal((n, heads, d)).astype(np.float32)

    def loss_xla(zz, aa, bb):
        return sum(jnp.sum(_xla_reference(gj, zz[:, h], aa[:, h], bb[:, h],
                                          SLOPE) * w[:, h])
                   for h in range(heads))
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (z, a, b)]
    out = K.gat_attention_dedup_chunked(gt, *leaves, SLOPE)
    (out * torch.from_numpy(w)).sum().backward()
    want = jax.grad(loss_xla, argnums=(0, 1, 2))(*_j(z, a, b))
    want_k = run_interpret(lambda: jax.grad(
        lambda *v: jnp.sum(jchunked(gj, *v, SLOPE) * w),
        argnums=(0, 1, 2))(*_j(z, a, b)))
    for leaf, g1, g2 in zip(leaves, want, want_k):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g1), **EXACT)
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g2), **EXACT)


@pytest.mark.parametrize("heads,hidden", [(3, 12), (9, 12)])
def test_gat_apply_chunked_route(rng, heads, hidden):
    """All heads in one call per chunk (3 x 128 <= 1024) and one call
    per head (9 x 128 > 1024), against the JAX ``pallas`` route in
    interpret mode and the segment path."""
    n = 300
    gj, gt = _pair(rng, n, 1500)
    cfg = jgat.GATConfig(in_feats=8, n_hidden=hidden, n_classes=3,
                         n_layers=2, n_heads=heads)
    jp = jgat.init(jax.random.PRNGKey(0), cfg)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    xt = torch.from_numpy(x)
    assert TS.resolve_gat_backend(gt) == "segment"     # auto: flat only
    got = tgat.apply(tp, gt, xt, cfg, backend="dedup").numpy()
    want = np.asarray(jgat.apply(jp, gj, *_j(x), cfg))
    kern = run_interpret(lambda: jgat.apply(jp, gj, *_j(x), cfg,
                                            backend="pallas"))
    np.testing.assert_allclose(got, kern, **KERNEL)
    np.testing.assert_allclose(got, want, **EXACT)
    np.testing.assert_allclose(
        tgat.apply(tp, gt, xt, cfg, backend="segment").numpy(), want,
        **EXACT)


def test_chunked_attention_rejects_other_layouts(rng):
    s, r = make_random_graph(rng, 300, 1500)
    g = TG.graph_from_edges(s, r, 300, tiles=True)
    z = torch.zeros((300, 1, 4))
    with pytest.raises(ValueError):
        K.gat_attention_dedup_chunked(g, z, z[:, :, 0], z[:, :, 0])
    m = g.n_edges
    split = g.replace(dedup_c=TG._build_dedup_split_chunked(
        g.senders[:m].numpy(), g.receivers[:m].numpy(), 300, threshold=4))
    with pytest.raises(ValueError):
        K.gat_attention_dedup_chunked(split, z, z[:, :, 0], z[:, :, 0])
