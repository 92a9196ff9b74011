"""The port's v1 GAT attention (``ops/gat_tiled.py``: K7's plain forward
and the K8 -> K9 plain fused backward) against the JAX package.

Against the exact composite (``_xla_reference`` and its ``jax.grad``)
the plain kernels agree to 1e-5 forward and rtol 1e-4 / atol 1e-5 in the
gradients: both are fp32 and differ in summation order only.  Against
``gat_attention_pallas`` in interpret mode the forward bar is the JAX
tests' 5e-3, since the TPU kernel rounds its probability matrix to bf16
(``tests/test_pallas_gat.py:20-30``); the interpret-mode backward is not
run here (it was seen to deadlock in whole-suite runs).  ``gat.apply``
and ``train_full_graph`` with GAT on a v1 graph are held against the JAX
segment path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gist_tpu.graph as JG
from conftest import make_random_graph
from gist_tpu.data.container import Dataset as JDataset
from gist_tpu.models import gat as jgat
from gist_tpu.ops import pallas_gat as JP
from gist_tpu.train.common import TrainConfig as JTrainConfig
from gist_tpu.train.full_graph import train_full_graph as jax_train

import gist_tpu_torch.graph as TG
from gist_tpu_torch.convert import params_from_jax
from gist_tpu_torch.data.container import Dataset
from gist_tpu_torch.models import gat as tgat
from gist_tpu_torch.ops import gat_dedup
from gist_tpu_torch.ops import gat_tiled as K
from gist_tpu_torch.ops import spmm as TS
from gist_tpu_torch.train.common import TrainConfig
from gist_tpu_torch.train.full_graph import train_full_graph
from torch_port_helpers import load_jax_partitioner, run_interpret

SLOPE = 0.01
EXACT = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


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
        # receivers below 40 of 260 nodes: empty rows and a trailing
        # empty tile (``tests/test_pallas_gat.py:72-139``)
        return rng.integers(0, 260, 150), rng.integers(0, 40, 150), 260
    if case == "parallel":
        s = np.concatenate([np.full(128, 5), rng.integers(0, 300, 400)])
        r = np.concatenate([np.full(128, 7), rng.integers(0, 300, 400)])
        return s, r, 300
    raise ValueError(case)


CASES = ["random", "multi_chunk", "empty", "parallel"]


def _inputs(rng, n, d):
    z = rng.standard_normal((n, d)).astype(np.float32)
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    w = rng.standard_normal((n, d)).astype(np.float32)
    return z, a, b, w


def _jax_reference(gj, z, a, b, w):
    """The composite's output and the gradients of sum(out * w)."""
    def loss(z, a, b):
        out = JP._xla_reference(gj, z, a, b, SLOPE)
        return jnp.sum(out * w), out
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(z), jnp.asarray(a), jnp.asarray(b))
    return np.asarray(out), [np.asarray(x) for x in grads]


def _port(graph, z, a, b, w):
    leaves = [torch.tensor(v, requires_grad=True) for v in (z, a, b)]
    out = K.gat_attention_tiled(graph, *leaves, SLOPE)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


def _softmax_stats(s, r, n, a, b):
    """Per receiver: the max score and sum exp(score - max) (numpy)."""
    sc = a[s] + b[r]
    sc = np.where(sc > 0, sc, SLOPE * sc)
    m = np.full(n, -np.inf, np.float64)
    np.maximum.at(m, r, sc)
    l = np.zeros(n)
    np.add.at(l, r, np.exp(sc - m[r]))
    return m, l


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("d", [8, 32])
def test_plain_k7_matches_composite(rng, case, d):
    """out against ``_xla_reference`` at 1e-5; m and l against the
    segment max and softmax denominator; empty rows give out 0, m -1e30
    and l 0 (the TPU kernel's initial values)."""
    s, r, n = _edges(case, rng)
    gt = TG.graph_from_edges(s, r, n, tiles=True, tile_mode="gather")
    z, a, b, _ = _inputs(rng, n, d)
    t = TG.pad_tiled_csr(gt.tiled, gt.tiled.senders.shape[0] + 1024,
                         gt.tiled.max_chunks + 1)
    before = K.launches_fwd
    out, m, l = K.gat_tiled_fwd(t, torch.from_numpy(z), torch.from_numpy(a),
                                torch.from_numpy(b), SLOPE)
    assert K.launches_fwd == before
    assert out.shape == (t.num_tiles * 128, d) and m.shape == l.shape == (
        t.num_tiles * 128,)
    want = np.asarray(JP._xla_reference(JG.graph_from_edges(s, r, n),
                                        jnp.asarray(z), jnp.asarray(a),
                                        jnp.asarray(b), SLOPE))
    np.testing.assert_allclose(out[:n].numpy(), want, rtol=1e-5, atol=1e-5)
    m_ref, l_ref = _softmax_stats(s, r, n, a, b)
    has = np.bincount(r, minlength=n) > 0
    np.testing.assert_allclose(m[:n].numpy()[has], m_ref[has], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(l[:n].numpy()[has], l_ref[has], rtol=1e-5)
    assert torch.all(out[:n][~has] == 0) and torch.all(out[n:] == 0)
    assert torch.all(m[:n][~has] == K.NEG_INF) and torch.all(l[:n][~has] == 0)


@pytest.mark.parametrize("case", CASES)
def test_plain_k7_matches_interpret_mode(rng, case):
    s, r, n = _edges(case, rng)
    gj = JG.graph_from_edges(s, r, n, tiles=True, tile_mode="gather")
    gt = TG.graph_from_edges(s, r, n, tiles=True, tile_mode="gather")
    z, a, b, _ = _inputs(rng, n, 16)
    got = K.gat_attention_tiled(gt, *map(torch.from_numpy, (z, a, b)),
                                SLOPE).numpy()
    want = run_interpret(lambda: JP.gat_attention_pallas(
        gj, jnp.asarray(z), jnp.asarray(a), jnp.asarray(b), SLOPE))
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
    if case == "empty":
        np.testing.assert_array_equal(got[40:], 0.0)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("d", [8, 32])
def test_plain_fused_backward_matches_jax_grad(rng, case, d):
    """K8 then K9 (plain walks) for z, src and dst against ``jax.grad``
    of the exact composite; the ``xla`` backward mode gives the same."""
    s, r, n = _edges(case, rng)
    gt = TG.graph_from_edges(s, r, n, tiles=True, tile_mode="gather")
    assert gt.tiled.pos_in_other is not None
    z, a, b, w = _inputs(rng, n, d)
    got, grads = _port(gt, z, a, b, w)
    want, wgrads = _jax_reference(JG.graph_from_edges(s, r, n), z, a, b, w)
    assert all(np.isfinite(g).all() for g in grads)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for g, wg in zip(grads, wgrads):
        np.testing.assert_allclose(g, wg, **EXACT)
    gat_dedup.set_gat_backward("xla")
    try:
        _, xgrads = _port(gt, z, a, b, w)
    finally:
        gat_dedup.set_gat_backward("fused")
    for g, wg in zip(xgrads, wgrads):
        np.testing.assert_allclose(g, wg, **EXACT)


def test_fused_backward_wrappers_and_fallback(rng):
    """K8 writes ds at the real slots only (zero on padding), K9 reads it
    through ``pos_in_other``; the per-row outputs cover every tile row.
    Without ``tiled_t`` the backward goes through the composite, as the
    JAX package's does."""
    s, r, n = _edges("empty", rng)
    gt = TG.graph_from_edges(s, r, n, tiles=True, tile_mode="gather")
    z, a, b, w = _inputs(rng, n, 8)
    zt, at, bt = map(torch.from_numpy, (z, a, b))
    out, m, l = K.gat_tiled_fwd(gt.tiled, zt, at, bt, SLOPE)
    g = torch.from_numpy(w)
    ds, ddst = K.gat_tiled_bwd_b1(gt.tiled, zt, at, bt, m, l, g, SLOPE)
    pad = gt.tiled.receivers == gt.tiled.num_tiles * 128
    assert ds.shape == gt.tiled.senders.shape and torch.all(ds[pad] == 0)
    assert ddst.shape == (gt.tiled.num_tiles * 128,)
    dz, dsrc = K.gat_tiled_bwd_b2(gt.tiled_t, ds, g, at, bt, m, l, SLOPE,
                                  torch.bfloat16)
    assert dz.dtype == torch.bfloat16 and dsrc.shape == (
        gt.tiled_t.num_tiles * 128,)
    _, wgrads = _jax_reference(JG.graph_from_edges(s, r, n), z, a, b, w)
    np.testing.assert_allclose(ddst[:n].numpy(), wgrads[2], **EXACT)
    np.testing.assert_allclose(dsrc[:n].numpy(), wgrads[1], **EXACT)
    got, grads = _port(gt.replace(tiled_t=None), z, a, b, w)
    for gg, wg in zip(grads, wgrads):
        np.testing.assert_allclose(gg, wg, **EXACT)
    with pytest.raises(ValueError, match="v1 layout"):
        K.gat_attention_tiled(TG.graph_from_edges(s, r, n), zt, at, bt)


@pytest.mark.parametrize("heads,hidden", [(2, 16), (9, 8)])
def test_gat_apply_on_v1_matches_jax(rng, heads, hidden):
    """``gat.apply`` with the kernel backend on a v1 graph (K7 per head,
    K8 and K9 per head: plain walks) against the JAX segment path with
    the JAX initial parameters: logits and every parameter gradient.
    heads * 128 is at most 1024 in one case and above it in the other;
    v1 runs one head a call in both."""
    n = 400
    s, r = make_random_graph(rng, n, 2400)
    gj = JG.graph_from_edges(s, r, n)
    gt = TG.graph_from_edges(s, r, n, tiles=True, tile_mode="gather")
    cfg = jgat.GATConfig(12, hidden, 5, n_layers=2, n_heads=heads)
    jp = jgat.init(jax.random.PRNGKey(1), cfg)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    cot = rng.standard_normal((n, 5)).astype(np.float32)

    def jloss(p):
        logits = jgat.apply(p, gj, jnp.asarray(x), cfg, backend="segment")
        return jnp.sum(logits * cot), logits

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    leaves = [t.requires_grad_(True)
              for l in tp["layers"] for t in l.values()]
    tcfg = tgat.GATConfig(12, hidden, 5, n_layers=2, n_heads=heads)
    seen = []
    real = K.gat_attention_tiled

    def spy(*args, **kw):
        seen.append(args[1].shape)
        return real(*args, **kw)
    K.gat_attention_tiled = spy
    try:
        got = tgat.apply(tp, gt, torch.from_numpy(x), tcfg,
                         backend="dedup")
    finally:
        K.gat_attention_tiled = real
    assert len(seen) == heads + 1      # one call per head of each layer
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    jleaves = [np.asarray(v) for l in jgrads["layers"] for v in l.values()]
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-4, atol=1e-5)


def test_train_full_graph_gat_on_v1_matches_jax(rng):
    """GAT through ``train_full_graph`` (``model=gat``) on a v1 graph
    against the JAX trainer on the segment path, from the JAX initial
    parameters: losses to 1e-4 relative, accuracies to one validation
    node."""
    n, f, c = 1200, 16, 5
    s, r = make_random_graph(rng, n, 6000)
    feats = rng.standard_normal((n, f)).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    split = rng.random(n)
    masks = (split < 0.5, (split >= 0.5) & (split < 0.75), split >= 0.75)
    jds, tds = [cls("tiny-rand", s, r, feats.copy(), labels.copy(), *masks, c)
                for cls in (JDataset, Dataset)]
    kw = dict(lr=1e-2, weight_decay=5e-4, n_epochs=6)
    cfg = jgat.GATConfig(f, 16, c, n_layers=2, n_heads=2)
    want = jax_train(jds, cfg, JTrainConfig(**kw), model=jgat,
                     verbose=False)
    init = jax.tree.map(np.asarray, jgat.init(jax.random.PRNGKey(0), cfg))
    graph = TG.graph_from_edges(s, r, n, tiles=True, tile_mode="gather")
    TS.set_default_backend("dedup")
    try:
        got = train_full_graph(tds, tgat.GATConfig(f, 16, c, n_layers=2,
                                                   n_heads=2),
                               TrainConfig(**kw), model=tgat,
                               init_params=init, graph=graph, device="cpu",
                               verbose=False)
    finally:
        TS.set_default_backend("auto")
    n_val = int(tds.val_mask.sum())
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    for k in ("val_accs", "test_accs"):
        np.testing.assert_allclose(got[k], want[k], atol=1.0 / n_val + 1e-7)
    assert got["losses"][-1] < got["losses"][0]
