"""The port's GAT model against the JAX package with the same parameters
(JAX ``gat.init`` output carried over by ``convert.py``): both kernel
routes (all heads in one call, one call per head) and the segment path,
forward and every parameter gradient.  fp32 bars rtol 1e-4 / atol 1e-5:
the plain kernels and the composite differ in summation order only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gist_tpu.graph as JG
from gist_tpu.models import common as jcommon
from gist_tpu.models import gat as jgat

import gist_tpu_torch.graph as TG
from gist_tpu_torch.convert import params_from_jax, params_to_numpy
from gist_tpu_torch.models import common as tcommon
from gist_tpu_torch.models import gat as tgat
from gist_tpu_torch.ops import gat_dedup
from gist_tpu_torch.ops import spmm as TS
from torch_port_helpers import load_jax_partitioner

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _graphs(rng, n=300, e=2000):
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    return JG.graph_from_edges(s, r, n), TG.graph_from_edges(s, r, n,
                                                             tiles=True), n


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


@pytest.mark.parametrize("backend,heads", [("dedup", 2), ("dedup", 9),
                                           ("segment", 3)])
def test_gat_apply_forward_and_param_grads(rng, monkeypatch, backend,
                                           heads):
    """heads 2: every layer takes the all-heads kernel call; heads 9
    (9 x 128 > 1024 lanes): the hidden layer takes one call per head."""
    gj, gt, n = _graphs(rng)
    kw = dict(in_feats=10, n_hidden=12, n_classes=4, n_layers=3,
              n_heads=heads)
    jcfg, tcfg = jgat.GATConfig(**kw), tgat.GATConfig(**kw)
    jp = jgat.init(jax.random.PRNGKey(0), jcfg)
    x = rng.standard_normal((n, 10)).astype(np.float32)
    labels = rng.integers(0, 4, n)
    mask = rng.random(n) < 0.7

    def jloss(pp):
        logits = jgat.apply(pp, gj, jnp.asarray(x), jcfg, train=True)
        return jcommon.masked_cross_entropy(logits, jnp.asarray(labels),
                                            jnp.asarray(mask)), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(jp)

    calls = {"mh": 0, "single": 0}
    for name, key in (("gat_attention_dedup_mh", "mh"),
                      ("gat_attention_dedup", "single")):
        def spy(*a, _f=getattr(gat_dedup, name), _k=key, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(gat_dedup, name, spy)
    tp = params_from_jax(_np_tree(jp))
    leaves = [t.requires_grad_(True) for l in tp["layers"] for t in l.values()]
    tlogits = tgat.apply(tp, gt, torch.from_numpy(x), tcfg, train=True,
                         generator=torch.Generator().manual_seed(0),
                         backend=backend)
    tl = tcommon.masked_cross_entropy(tlogits, torch.from_numpy(labels),
                                      torch.from_numpy(mask))
    tl.backward()
    assert len(leaves) == 6
    if backend == "dedup":
        assert calls == ({"mh": 3, "single": 0} if heads == 2
                         else {"mh": 1, "single": 2 * heads})
    else:
        assert calls == {"mh": 0, "single": 0}
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    for jl_, tl_ in zip(jg["layers"], tp["layers"]):
        for k in ("w", "attn"):
            np.testing.assert_allclose(tl_[k].grad.numpy(),
                                       np.asarray(jl_[k]), err_msg=k, **TOL)


def test_gat_apply_bf16_tracks_jax(rng):
    gj, gt, n = _graphs(rng)
    kw = dict(in_feats=10, n_hidden=16, n_classes=4, n_layers=2, n_heads=2,
              dtype="bfloat16")
    jcfg, tcfg = jgat.GATConfig(**kw), tgat.GATConfig(**kw)
    jp = jgat.init(jax.random.PRNGKey(3), jcfg)
    x = rng.standard_normal((n, 10)).astype(np.float32)
    want = np.asarray(jgat.apply(jp, gj, jnp.asarray(x), jcfg))
    for backend in ("segment", "dedup"):
        got = tgat.apply(params_from_jax(_np_tree(jp)), gt,
                         torch.from_numpy(x), tcfg, backend=backend)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-2, atol=3e-2)


def test_layer_shapes_init_and_convert(rng):
    for k in (1, 2, 3):
        kw = dict(in_feats=30, n_hidden=20, n_classes=6, n_layers=3,
                  n_heads=2, num_subnet=k)
        assert (tgat.GATConfig(**kw).layer_shapes()
                == jgat.GATConfig(**kw).layer_shapes())
    cfg = tgat.GATConfig(602, 512, 41, n_layers=2, n_heads=2)
    assert cfg.sub_config(2).layer_shapes() == [(602, 256, 2), (256, 41, 1)]
    p = tgat.init(torch.Generator().manual_seed(0), cfg)
    w0, a0 = p["layers"][0]["w"], p["layers"][0]["attn"]
    assert w0.shape == (2, 602, 512) and a0.shape == (2, 1024)
    std = np.sqrt(2.0) * np.sqrt(2.0 / (602 + 512))
    assert abs(float(w0.std()) / std - 1) < 0.02
    assert abs(float(a0.std()) / (np.sqrt(2.0) * np.sqrt(2.0 / 2048)) - 1) \
        < 0.1
    jp = _np_tree(jgat.init(jax.random.PRNGKey(1), jgat.GATConfig(
        8, 12, 3, n_layers=3, n_heads=2)))
    back = params_to_numpy(params_from_jax(jp))
    for la, lb in zip(jp["layers"], back["layers"]):
        assert la.keys() == lb.keys() == {"w", "attn"}
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k])


def test_xavier_normal_gain_matches_jax_std():
    g = torch.Generator().manual_seed(0)
    t = tcommon.xavier_normal_gain(g, (300, 200), 2.0)
    j = np.asarray(jcommon.xavier_normal_gain(jax.random.PRNGKey(0),
                                              (300, 200), 2.0))
    assert abs(float(t.std()) / float(j.std()) - 1) < 0.02
    assert abs(float(t.mean())) < 0.01


def test_resolve_gat_backend(rng):
    _, gt, _ = _graphs(rng)
    assert TS.resolve_gat_backend(gt) == "segment"       # CPU graph
    assert TS.resolve_gat_backend(gt, "dedup") == "dedup"
    assert TS.resolve_gat_backend(gt.replace(dedup_t=None)) == "segment"
    with pytest.raises(ValueError, match="backend"):
        tgat.apply(params_from_jax(_np_tree(jgat.init(
            jax.random.PRNGKey(0), jgat.GATConfig(4, 4, 2)))), gt,
            torch.zeros((gt.n_nodes, 4)), tgat.GATConfig(4, 4, 2),
            backend="pallas")
