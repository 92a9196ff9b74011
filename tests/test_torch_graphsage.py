"""The port's plain GraphSAGE stack, its layers and the multitask loss
and metric against the JAX package, with the same parameters (via
``convert.py``) and dropout 0: the affine LayerNorm, the SAGE layer
without its aggregation (the ``use_pp`` first layer), ``init_graphsage``
/ ``apply_graphsage``, the single-head ``gat_layer``, the sigmoid BCE and
the threshold micro-F1, and the IST stack's ``use_pp`` skip.  fp32
tolerance rtol = atol = 1e-5: only the summation order differs."""

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
from gist_tpu_torch.convert import params_from_jax
from gist_tpu_torch.models import common as tcommon
from gist_tpu_torch.models import layers as tlayers
from gist_tpu_torch.models import sage as tsage
from torch_port_helpers import load_jax_partitioner


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


TOL = dict(rtol=1e-5, atol=1e-5)


def _graphs(rng, tiles=False):
    n = 300
    s, r = rng.integers(0, n, 2500), rng.integers(0, n, 2500)
    return (JG.graph_from_edges(s, r, n, tiles=tiles),
            TG.graph_from_edges(s, r, n, tiles=tiles), n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _grads_close(jg, tp):
    for jl, tl in zip(jg["layers"], tp["layers"]):
        assert set(jl) == set(tl)
        for k in jl:
            np.testing.assert_allclose(tl[k].grad.numpy(), np.asarray(jl[k]),
                                       err_msg=k, **TOL)


def test_affine_layer_norm(rng):
    h = rng.standard_normal((40, 12)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(12).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    for args in ((), (scale,), (scale, bias)):
        want = jlayers.layer_norm(jnp.asarray(h),
                                  *(jnp.asarray(a) for a in args))
        got = tlayers.layer_norm(torch.from_numpy(h),
                                 *(torch.from_numpy(a) for a in args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = torch.nn.functional.layer_norm(torch.from_numpy(h), (12,),
                                         torch.from_numpy(scale),
                                         torch.from_numpy(bias))
    np.testing.assert_allclose(
        tlayers.layer_norm(torch.from_numpy(h), torch.from_numpy(scale),
                           torch.from_numpy(bias)).numpy(), got.numpy(),
        **TOL)


@pytest.mark.parametrize("aggregate_first", [False, True])
def test_sage_layer_affine_and_pp_skip(rng, aggregate_first):
    """``aggregate_first=False`` reads an input already 2*in wide; the
    affine LayerNorm's scale and bias get their gradients."""
    gj, gt, n = _graphs(rng)
    width = 32 if aggregate_first else 64
    x = rng.standard_normal((n, width)).astype(np.float32)
    p = {"w": rng.standard_normal((64, 8)).astype(np.float32) * 0.2,
         "b": rng.standard_normal(8).astype(np.float32),
         "ln_scale": rng.standard_normal(8).astype(np.float32),
         "ln_bias": rng.standard_normal(8).astype(np.float32)}
    cot = rng.standard_normal((n, 8)).astype(np.float32)
    kw = dict(affine_ln=True, aggregate_first=aggregate_first)

    def jloss(pp, xx):
        h = jlayers.sage_layer(gj, xx, pp, activation=jax.nn.relu, **kw)
        return jnp.sum(h * cot), h

    (_, jh), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    th = tlayers.sage_layer(gt, tx, tp, activation=torch.relu, **kw)
    (th * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), **TOL)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)


@pytest.mark.parametrize("use_pp,train", [(False, True), (True, True),
                                          (True, False)])
def test_graphsage_stack_matches(rng, use_pp, train):
    """init_graphsage's shapes and affine leaves, and apply_graphsage's
    logits and parameter gradients; with ``use_pp`` in training the
    input is ``[x || ah]`` and the first layer skips its aggregation,
    in eval the raw x is aggregated."""
    gj, gt, n = _graphs(rng)
    f = 16
    jcfg = jsage.SAGEConfig(f, 24, 5, n_layers=2, dropout=0.0,
                            use_pp=use_pp)
    tcfg = tsage.SAGEConfig(f, 24, 5, n_layers=2, dropout=0.0,
                            use_pp=use_pp)
    jp = jsage.init_graphsage(jax.random.PRNGKey(0), jcfg)
    tinit = tsage.init_graphsage(torch.Generator().manual_seed(0), tcfg)
    assert [{k: tuple(v.shape) for k, v in l.items()}
            for l in tinit["layers"]] == [
        {k: tuple(v.shape) for k, v in l.items()} for l in jp["layers"]]
    width = 2 * f if (use_pp and train) else f
    x = rng.standard_normal((n, width)).astype(np.float32)
    labels = rng.integers(0, 5, n)
    mask = rng.random(n) < 0.7

    def jloss(pp):
        logits = jsage.apply_graphsage(pp, gj, jnp.asarray(x), jcfg,
                                       train=train)
        return jcommon.masked_cross_entropy(logits, jnp.asarray(labels),
                                            jnp.asarray(mask)), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = params_from_jax(_np_tree(jp))
    for layer in tp["layers"]:
        for t in layer.values():
            t.requires_grad_(True)
    tlogits = tsage.apply_graphsage(tp, gt, torch.from_numpy(x), tcfg,
                                    train=train)
    tl = tcommon.masked_cross_entropy(tlogits, torch.from_numpy(labels),
                                      torch.from_numpy(mask))
    tl.backward()
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    _grads_close(jg, tp)


@pytest.mark.parametrize("tiles", [False, True])
def test_sage_apply_use_pp_in_training(rng, tiles):
    """The IST stack's ``use_pp`` skip: in training the first layer
    reads the 2*in-wide input without aggregating (the other layers go
    through K1's plain walk with a layout), in eval it aggregates the
    raw input."""
    gj, gt, n = _graphs(rng, tiles)
    backend = "dedup" if tiles else None
    jcfg = jsage.SAGEConfig(16, 24, 5, n_layers=2, dropout=0.0, use_pp=True)
    tcfg = tsage.SAGEConfig(16, 24, 5, n_layers=2, dropout=0.0, use_pp=True)
    jp = jsage.init(jax.random.PRNGKey(2), jcfg)
    labels = rng.integers(0, 5, n)
    mask = rng.random(n) < 0.7
    for train, width in ((True, 32), (False, 16)):
        x = rng.standard_normal((n, width)).astype(np.float32)

        def jloss(pp):
            logits = jsage.apply(pp, gj, jnp.asarray(x), jcfg, train=train,
                                 dropout_key=jax.random.PRNGKey(1))
            return jcommon.masked_cross_entropy(
                logits, jnp.asarray(labels), jnp.asarray(mask)), logits

        (_, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
        tp = params_from_jax(_np_tree(jp))
        for layer in tp["layers"]:
            for t in layer.values():
                t.requires_grad_(True)
        tlogits = tsage.apply(tp, gt, torch.from_numpy(x), tcfg, train=train,
                              backend=backend)
        tcommon.masked_cross_entropy(tlogits, torch.from_numpy(labels),
                                     torch.from_numpy(mask)).backward()
        np.testing.assert_allclose(tlogits.detach().numpy(),
                                   np.asarray(jlogits), **TOL)
        _grads_close(jg, tp)


def test_gat_layer_matches(rng):
    gj, gt, n = _graphs(rng)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    p = {"w": rng.standard_normal((12, 7)).astype(np.float32) * 0.3,
         "attn": rng.standard_normal(14).astype(np.float32) * 0.3}
    cot = rng.standard_normal((n, 7)).astype(np.float32)

    def jloss(pp, xx):
        h = jlayers.gat_layer(gj, xx, pp)
        return jnp.sum(h * cot), h

    (_, jh), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    th = tlayers.gat_layer(gt, tx, tp)
    (th * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), **TOL)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)


def test_masked_bce_multitask_value_and_grad(rng):
    logits = (rng.standard_normal((60, 5)) * 4).astype(np.float32)
    logits[0, 0], logits[1, 1] = 40.0, -40.0   # the stable form's tails
    labels = (rng.random((60, 5)) < 0.4).astype(np.float32)
    mask = rng.random(60) < 0.6
    jl, jg = jax.value_and_grad(jcommon.masked_bce_multitask)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    tlog = torch.tensor(logits, requires_grad=True)
    tl = tcommon.masked_bce_multitask(tlog, torch.from_numpy(labels),
                                      torch.from_numpy(mask))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    np.testing.assert_allclose(tlog.grad.numpy(), np.asarray(jg), **TOL)
    # the same as torch's own loss over the masked rows
    ref = torch.nn.functional.binary_cross_entropy_with_logits(
        torch.from_numpy(logits[mask]), torch.from_numpy(labels[mask]))
    np.testing.assert_allclose(float(tl.detach()), float(ref), **TOL)
    empty = tcommon.masked_bce_multitask(torch.from_numpy(logits),
                                         torch.from_numpy(labels),
                                         torch.zeros(60, dtype=torch.bool))
    assert float(empty) == 0.0


def test_micro_f1_multitask(rng):
    logits = rng.standard_normal((80, 6)).astype(np.float32)
    labels = (rng.random((80, 6)) < 0.3).astype(np.float32)
    mask = rng.random(80) < 0.5
    for lab in (labels, np.zeros_like(labels)):
        assert tcommon.micro_f1(logits, lab, mask, multitask=True) == \
            jcommon.micro_f1(logits, lab, mask, multitask=True)
    assert tcommon.micro_f1(-np.abs(logits), np.zeros_like(labels), mask,
                            multitask=True) == 0.0
    assert tcommon.micro_f1(logits, labels, np.zeros(80, bool),
                            multitask=True) == -1.0
