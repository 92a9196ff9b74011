"""The port's SAGE stack against the JAX package with the same
parameters (via ``convert.py``) and dropout 0.  fp32 tolerance
rtol = atol = 1e-5: only the summation order differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gist_tpu.graph as JG
from gist_tpu.models import common as jcommon
from gist_tpu.models import layers as jlayers
from gist_tpu.models import sage as jsage

import gist_tpu_torch.graph as TG
from gist_tpu_torch.convert import params_from_jax, params_to_numpy
from gist_tpu_torch.models import common as tcommon
from gist_tpu_torch.models import layers as tlayers
from gist_tpu_torch.models import sage as tsage
from torch_port_helpers import load_jax_partitioner


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


TOL = dict(rtol=1e-5, atol=1e-5)


def _graphs(rng, tiles):
    n = 300
    s, r = rng.integers(0, n, 2500), rng.integers(0, n, 2500)
    return (JG.graph_from_edges(s, r, n, tiles=tiles),
            TG.graph_from_edges(s, r, n, tiles=tiles), n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("tiles", [False, True])
def test_sage_layer_forward_and_grad(rng, tiles):
    gj, gt, n = _graphs(rng, tiles)
    backend = "dedup" if tiles else None
    x = rng.standard_normal((n, 16)).astype(np.float32)
    p = {"w": rng.standard_normal((32, 8)).astype(np.float32) * 0.2,
         "b": rng.standard_normal(8).astype(np.float32)}
    cot = rng.standard_normal((n, 8)).astype(np.float32)

    def jloss(pp, xx):
        h = jlayers.sage_layer(gj, xx, pp, activation=jax.nn.relu)
        return jnp.sum(h * cot), h

    (_, jh), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    th = tlayers.sage_layer(gt, tx, tp, activation=torch.relu,
                            backend=backend)
    (th * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), **TOL)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)


@pytest.mark.parametrize("tiles", [False, True])
def test_sage_apply_forward_and_param_grads(rng, tiles):
    gj, gt, n = _graphs(rng, tiles)
    backend = "dedup" if tiles else None
    jcfg = jsage.SAGEConfig(16, 24, 5, n_layers=3, dropout=0.0)
    tcfg = tsage.SAGEConfig(16, 24, 5, n_layers=3, dropout=0.0)
    jp = jsage.init(jax.random.PRNGKey(0), jcfg)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    labels = rng.integers(0, 5, n)
    mask = rng.random(n) < 0.7

    def jloss(pp):
        logits = jsage.apply(pp, gj, jnp.asarray(x), jcfg, train=True,
                             dropout_key=jax.random.PRNGKey(1))
        return jcommon.masked_cross_entropy(logits, jnp.asarray(labels),
                                            jnp.asarray(mask)), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = params_from_jax(_np_tree(jp))
    leaves = [t.requires_grad_(True) for l in tp["layers"] for t in l.values()]
    tlogits = tsage.apply(tp, gt, torch.from_numpy(x), tcfg, train=True,
                          generator=torch.Generator().manual_seed(1),
                          backend=backend)
    tl = tcommon.masked_cross_entropy(tlogits, torch.from_numpy(labels),
                                      torch.from_numpy(mask))
    tl.backward()
    assert len(leaves) == 8
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    for jl_, tl_ in zip(jg["layers"], tp["layers"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(tl_[k].grad.numpy(),
                                       np.asarray(jl_[k]), **TOL)


def test_sage_apply_bf16_tracks_jax(rng):
    gj, gt, n = _graphs(rng, False)
    jcfg = jsage.SAGEConfig(16, 24, 5, n_layers=2, dtype="bfloat16")
    tcfg = tsage.SAGEConfig(16, 24, 5, n_layers=2, dtype="bfloat16")
    jp = jsage.init(jax.random.PRNGKey(3), jcfg)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    want = np.asarray(jsage.apply(jp, gj, jnp.asarray(x), jcfg))
    got = tsage.apply(params_from_jax(_np_tree(jp)), gt, torch.from_numpy(x),
                      tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


def test_ist_layer_dims_flagship():
    """SAGE h2048 K=8, 4 hidden layers, split output (the slice's
    configuration)."""
    args = (100, 2048, 47, 4)
    kw = dict(split_output=True, num_subnet=8)
    want = [(100, 256), (256, 256), (256, 256), (256, 256), (256, 47)]
    assert tcommon.ist_layer_dims(*args, **kw) == want
    assert jcommon.ist_layer_dims(*args, **kw) == want
    for k in (1, 3, 7):
        for so in (False, True):
            assert (tcommon.ist_layer_dims(30, 20, 6, 3, split_output=so,
                                           num_subnet=k)
                    == jcommon.ist_layer_dims(30, 20, 6, 3, split_output=so,
                                              num_subnet=k))


def test_losses_and_metrics_match(rng):
    logits = rng.standard_normal((50, 6)).astype(np.float32)
    labels = rng.integers(0, 6, 50)
    mask = rng.random(50) < 0.5
    np.testing.assert_allclose(
        float(tcommon.masked_cross_entropy(torch.from_numpy(logits),
                                           torch.from_numpy(labels),
                                           torch.from_numpy(mask))),
        float(jcommon.masked_cross_entropy(jnp.asarray(logits),
                                           jnp.asarray(labels),
                                           jnp.asarray(mask))), **TOL)
    assert float(tcommon.masked_accuracy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(mask))) == pytest.approx(float(
            jcommon.masked_accuracy(jnp.asarray(logits), jnp.asarray(labels),
                                    jnp.asarray(mask))))
    assert tcommon.micro_f1(logits, labels, mask) == \
        jcommon.micro_f1(logits, labels, mask)


def test_init_and_dropout():
    cfg = tsage.SAGEConfig(10, 16, 3, n_layers=2)
    p = tsage.init(torch.Generator().manual_seed(0), cfg)
    shapes = [(l["w"].shape, l["b"].shape) for l in p["layers"]]
    assert shapes == [((20, 16), (16,)), ((32, 16), (16,)), ((32, 3), (3,))]
    for l, (d_in, _) in zip(p["layers"], cfg.layer_dims()):
        assert float(l["w"].abs().max()) <= 1 / np.sqrt(2 * d_in)
    back = params_from_jax(params_to_numpy(p))
    for a, b in zip(p["layers"], back["layers"]):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    h = torch.ones(200, 50)
    out = tlayers.dropout(h, 0.5, torch.Generator().manual_seed(0))
    kept = out != 0
    assert 0.4 < float(kept.float().mean()) < 0.6
    assert torch.all(out[kept] == 2.0)
    assert tlayers.dropout(h, 0.5, None) is h
