"""The port's GCN (``graph_conv``, the whole-tensor LayerNorm,
``gcn.init``/``gcn.apply``) and full-graph trainer against the JAX
package, with the same parameters and dropout 0.

``gcn.apply`` runs on the flat, chunked and split layouts (K1's and K2's
plain walks) against the JAX segment path at rtol = atol = 1e-4, the
dedup tests' bar; the layer primitives on the segment path at 1e-5.
``train_full_graph`` on a graph forced to the chunked layout holds the
JAX trainer's losses to 1e-4 relative and its accuracies to one
validation node."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gist_tpu.graph as JG
from conftest import make_random_graph
from gist_tpu.data.container import Dataset as JDataset
from gist_tpu.models import gcn as jgcn
from gist_tpu.models import layers as jlayers
from gist_tpu.train.common import TrainConfig as JTrainConfig
from gist_tpu.train.full_graph import train_full_graph as jax_train

import gist_tpu_torch.graph as TG
from gist_tpu_torch.convert import params_from_jax, params_to_numpy
from gist_tpu_torch.data.container import Dataset
from gist_tpu_torch.models import common as tcommon
from gist_tpu_torch.models import gcn as tgcn
from gist_tpu_torch.models import layers as tlayers
from gist_tpu_torch.ops import spmm as TS
from gist_tpu_torch.train.common import TrainConfig
from gist_tpu_torch.train.full_graph import train_full_graph
from torch_port_helpers import load_jax_partitioner


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_glorot_uniform_bounds():
    g = torch.Generator().manual_seed(0)
    w = tcommon.glorot_uniform(g, (300, 100))
    limit = np.sqrt(6.0 / 400)
    assert w.shape == (300, 100) and w.dtype == torch.float32
    assert float(w.abs().max()) <= limit
    assert abs(float(w.mean())) < 0.02 * limit
    assert abs(float(w.std()) - limit / np.sqrt(3)) < 0.02 * limit
    again = tcommon.glorot_uniform(torch.Generator().manual_seed(0),
                                   (300, 100))
    assert torch.equal(w, again)


def test_gcn_init_and_convert_round_trip():
    cfg = tgcn.GCNConfig(24, 16, 5, n_layers=2)
    jp = _np_tree(jgcn.init(jax.random.PRNGKey(0), cfg))
    tp = params_from_jax(jp)
    back = params_to_numpy(tp)
    for a, b in zip(jp["layers"], back["layers"]):
        assert a.keys() == b.keys() == {"w", "b"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    mine = tgcn.init(torch.Generator().manual_seed(0), cfg)
    assert [tuple(l["w"].shape) for l in mine["layers"]] == [
        a["w"].shape for a in jp["layers"]] == [(24, 16), (16, 16), (16, 5)]
    assert all(float(l["b"].abs().sum()) == 0 for l in mine["layers"])


def test_whole_tensor_layer_norm():
    x = np.random.default_rng(0).standard_normal((50, 7)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.whole_tensor_layer_norm(torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.whole_tensor_layer_norm(jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d_in,d_out", [(16, 8), (8, 16)])
def test_graph_conv_forward_and_grad(rng, d_in, d_out):
    """Both projection orders; degree-0 nodes get norm 0."""
    n = 200
    s, r = rng.integers(0, 150, 1200), rng.integers(0, 150, 1200)
    gj, gt = JG.graph_from_edges(s, r, n), TG.graph_from_edges(s, r, n)
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    w = rng.standard_normal((d_in, d_out)).astype(np.float32) * 0.3
    b = rng.standard_normal(d_out).astype(np.float32)
    cot = rng.standard_normal((n, d_out)).astype(np.float32)

    def jloss(w_, b_, x_):
        return jnp.sum(jlayers.graph_conv(gj, x_, w_, b_,
                                          activation=jax.nn.relu) * cot)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(w), jnp.asarray(b), jnp.asarray(x))
    leaves = [torch.tensor(v, requires_grad=True) for v in (w, b, x)]
    out = tlayers.graph_conv(gt, leaves[2], leaves[0], leaves[1],
                             activation=torch.relu)
    (out * torch.from_numpy(cot)).sum().backward()
    want = jlayers.graph_conv(gj, jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b), activation=jax.nn.relu)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for a, g in zip(leaves, jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-5)
    assert np.all(out.detach().numpy()[150:] == np.maximum(b, 0))


def _layout_graph(layout, s, r, n):
    g = TG.graph_from_edges(s, r, n)
    if layout == "flat":
        return g.with_tiles()
    if layout == "chunked":
        g = g.with_tiles(mode="dedup-chunked", chunk_rows=2048)
        assert g.dedup_c.n_chunks > 1
        return g
    m = g.n_edges
    kw = dict(tile_rows=64, threshold=8, chunk_rows=2048)
    return g.replace(
        dedup_c=TG._build_dedup_split_chunked(
            g.senders[:m].numpy(), g.receivers[:m].numpy(), n, **kw),
        dedup_c_t=TG._build_dedup_split_chunked(
            g.t_senders[:m].numpy(), g.t_receivers[:m].numpy(), n, **kw))


@pytest.mark.parametrize("layout", ["flat", "chunked", "split"])
def test_gcn_apply_matches_jax(rng, layout):
    """Forward and every parameter gradient: JAX segment path vs the
    port's kernels' plain walks on each layout."""
    n = 1200
    s, r = make_random_graph(rng, n, 6000)
    gj = JG.graph_from_edges(s, r, n)
    gt = _layout_graph(layout, s, r, n)
    cfg = jgcn.GCNConfig(20, 24, 6, n_layers=2, dropout=0.0)
    jp = jgcn.init(jax.random.PRNGKey(3), cfg)
    x = rng.standard_normal((n, 20)).astype(np.float32)
    cot = rng.standard_normal((n, 6)).astype(np.float32)

    def jloss(p):
        logits = jgcn.apply(p, gj, jnp.asarray(x), cfg, backend="segment")
        return jnp.sum(logits * cot), logits

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = params_from_jax(_np_tree(jp))
    leaves = [t.requires_grad_(True)
              for l in tp["layers"] for t in l.values()]
    got = tgcn.apply(tp, gt, torch.from_numpy(x), cfg, train=True,
                     backend="dedup")
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    jleaves = [np.asarray(v) for l in jgrads["layers"] for v in l.values()]
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-4, atol=1e-4)


def test_gcn_apply_bf16_returns_fp32(rng):
    n = 300
    s, r = make_random_graph(rng, n, 1500)
    g = TG.graph_from_edges(s, r, n)
    cfg = tgcn.GCNConfig(12, 16, 4, dtype="bfloat16")
    p = tgcn.init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(rng.standard_normal((n, 12)).astype(np.float32))
    out = tgcn.apply(p, g, x, cfg)
    ref = tgcn.apply(p, g, x, tgcn.GCNConfig(12, 16, 4))
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=5e-2, atol=5e-2)
    with pytest.raises(ValueError):
        tgcn.apply(p, g, x, tgcn.GCNConfig(12, 16, 4, dtype="float16"))


def _datasets(rng, n=1500, f=16, c=5):
    s, r = make_random_graph(rng, n, 7000)
    feats = rng.standard_normal((n, f)).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    split = rng.random(n)
    masks = (split < 0.5, (split >= 0.5) & (split < 0.75), split >= 0.75)
    return [cls("tiny-rand", s, r, feats.copy(), labels.copy(), *masks, c)
            for cls in (JDataset, Dataset)]


def test_train_full_graph_matches_jax(rng, monkeypatch):
    """The trainer on a graph forced to the chunked layout (threshold
    lowered, six chunks per direction) against the JAX trainer on the
    segment path, from the JAX initial parameters, with the LR schedule
    on."""
    jds, tds = _datasets(rng)
    cfg = jgcn.GCNConfig(16, 24, 5, n_layers=1, dropout=0.0)
    kw = dict(lr=1e-2, weight_decay=5e-4, n_epochs=8, lr_schedule=True)
    want = jax_train(jds, cfg, JTrainConfig(**kw), verbose=False)
    init = _np_tree(jgcn.init(jax.random.PRNGKey(0), cfg))

    monkeypatch.setattr(TG, "HUGE_EDGES", 1000)
    monkeypatch.setattr(TG, "CHUNK_ROWS", 2048)
    built = []
    real = TG.Graph.with_tiles

    def spy(self, *a, **k):
        g = real(self, *a, **k)
        built.append(g)
        return g
    monkeypatch.setattr(TG.Graph, "with_tiles", spy)
    TS.set_default_backend("dedup")
    try:
        got = train_full_graph(tds, tgcn.GCNConfig(16, 24, 5, n_layers=1,
                                                   dropout=0.0),
                               TrainConfig(**kw), init_params=init,
                               device="cpu", verbose=False)
    finally:
        TS.set_default_backend("auto")
    g = built[0]
    assert g.dedup is None and g.dedup_c.n_chunks >= 4
    assert g.dedup_c_t.n_chunks >= 4
    n_val = int(tds.val_mask.sum())
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    for k in ("val_accs", "test_accs"):
        np.testing.assert_allclose(got[k], want[k], atol=1.0 / n_val + 1e-7)
    assert set(want) <= set(got) and got["layout_build_s"] > 0
    assert got["losses"][-1] < got["losses"][0]


def test_train_full_graph_unported_modes_raise(rng):
    _, tds = _datasets(rng, n=200)
    cfg = tgcn.GCNConfig(16, 8, 5, dropout=0.0)
    scan = train_full_graph(tds, cfg, TrainConfig(n_epochs=6), scan_epochs=4,
                            device="cpu", verbose=False)
    loop = train_full_graph(tds, cfg, TrainConfig(n_epochs=6), device="cpu",
                            verbose=False)
    assert scan["scan_epochs"] == 4 and len(scan["losses"]) == 6
    np.testing.assert_allclose(scan["losses"], loop["losses"], rtol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            train_full_graph(tds, cfg, TrainConfig(n_epochs=1))
