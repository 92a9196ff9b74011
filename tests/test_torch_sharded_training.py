"""The port's graph-sharded training against the JAX package: the
sharded SAGE, GCN and GAT steps and the sharded infer in a gloo world
of four CPU ranks against JAX's ``shard_map`` steps on the 8-device CPU
mesh (synth-tiny, the same initial params, dropout 0), the first
step's summed gradients against the single-device gradient, the bf16
halo, a GCN dropout run, and the GAT step through K4's plain walk on
the interior layouts.

Losses and the initial params' logits agree to 1e-5 relative;
gradients to 1e-5 of their largest entry; the parameters after three
Adam steps to the tolerance JAX's own sharded-vs-single test uses, and
the logits they give to 1e-4 (Adam's first steps amplify last-bit
differences of a near-zero gradient)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

import gist_tpu.graph as G
from gist_tpu.data import synthetic_dataset
from gist_tpu.models import gat as jgat
from gist_tpu.models import gcn as jgcn
from gist_tpu.models import sage as jsage
from gist_tpu.models.common import masked_cross_entropy
from gist_tpu.parallel import build_sharded_graph
from gist_tpu.parallel.graph_shard import shard_features, unshard
from gist_tpu.parallel.train import build_sharded_infer, build_sharded_step
from gist_tpu.train.common import make_optimizer

from torch_dist_workers import run_world
from torch_port_helpers import load_jax_partitioner

WORLD = 4
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _ds():
    return synthetic_dataset("synth-tiny")


def _edges(kind):
    ds = _ds()
    if kind != "gcn":
        return ds.senders, ds.receivers
    loops = np.arange(ds.n_nodes)
    return (np.concatenate([ds.senders, loops]),
            np.concatenate([ds.receivers, loops]))


def _model(kind):
    ds = _ds()
    if kind == "sage":
        return jsage, jsage.SAGEConfig(ds.in_feats, 16, ds.n_classes,
                                       n_layers=1, dropout=0.0)
    if kind == "gcn":
        return jgcn, jgcn.GCNConfig(ds.in_feats, 16, ds.n_classes,
                                    n_layers=2, dropout=0.0)
    return jgat, jgat.GATConfig(ds.in_feats, 16, ds.n_classes, n_layers=2,
                                n_heads=2)


def _init(kind):
    m, cfg = _model(kind)
    return jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0), cfg))


CASES = {
    "sage": dict(kind="sage"),
    "gcn": dict(kind="gcn", ds="ds_loops"),
    "gat": dict(kind="gat"),
    "sage_bf16": dict(kind="sage", halo_dtype="bfloat16"),
    "gat_tiles": dict(kind="gat", tiles=True),
}


@pytest.fixture(scope="module")
def port():
    ds = _ds()
    data = dict(n=ds.n_nodes, x=ds.features, labels=ds.labels,
                mask=ds.train_mask)
    s, r = _edges("gcn")
    payload = {"ds": dict(data, s=ds.senders, r=ds.receivers),
               "ds_loops": dict(data, s=s, r=r),
               "init": {k: _init(k) for k in ("sage", "gcn", "gat")}}
    cases = [(k, dict(fn="sharded_train", steps=STEPS, **v))
             for k, v in CASES.items()]
    cases.append(("gcn_dropout", dict(fn="sharded_train", kind="gcn",
                                      steps=6, dropout=0.5)))
    return run_world(WORLD, cases, payload, timeout_s=120)


def _jax_sharded(kind, halo_dtype=None):
    ds = _ds()
    s, r = _edges(kind)
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("graph",))
    sg = build_sharded_graph(s, r, ds.n_nodes, WORLD)
    perm = np.asarray(sg.node_perm)
    lab = np.zeros(sg.total_rows, np.int32)
    lab[perm] = ds.labels
    msk = np.zeros(sg.total_rows, bool)
    msk[perm] = ds.train_mask
    xs = shard_features(sg, ds.features, mesh)
    init_opt, step = build_sharded_step(sg, mesh, kind=kind, lr=1e-2,
                                        weight_decay=0.0,
                                        halo_dtype=halo_dtype)
    p = jax.tree.map(jnp.asarray, _init(kind))
    st = init_opt(p)
    losses = []
    for _ in range(STEPS):
        p, st, loss = step(p, st, xs, jnp.asarray(lab), jnp.asarray(msk))
        losses.append(float(loss))
    infer = build_sharded_infer(sg, mesh, kind=kind, halo_dtype=halo_dtype)
    logits0 = np.asarray(unshard(sg, infer(
        jax.tree.map(jnp.asarray, _init(kind)), xs)))
    return losses, p, np.asarray(unshard(sg, infer(p, xs))), logits0


def _flat_grads(kind):
    ds = _ds()
    m, cfg = _model(kind)
    s, r = _edges(kind)
    g = G.graph_from_edges(s, r, ds.n_nodes)
    x, labels, mask = (jnp.asarray(a) for a in (ds.features, ds.labels,
                                                ds.train_mask))
    kw = {"backend": "segment"} if kind == "gat" else {}

    def loss_fn(p):
        return masked_cross_entropy(m.apply(p, g, x, cfg, **kw), labels,
                                    mask)
    return jax.grad(loss_fn)(jax.tree.map(jnp.asarray, _init(kind)))


def _tree_close(a, b, **tol):
    for la, lb in zip(a["layers"], b["layers"]):
        for k in la:
            np.testing.assert_allclose(np.asarray(lb[k]), np.asarray(la[k]),
                                       err_msg=k, **tol)


@pytest.mark.parametrize("kind", ["sage", "gcn", "gat"])
def test_sharded_step_and_infer_match_jax(port, kind):
    losses_j, p_j, logits_j, logits0_j = _jax_sharded(kind)
    grads_flat = _flat_grads(kind)
    for rank, (losses, params, logits, grads, logits0) in enumerate(
            port[kind]):
        np.testing.assert_allclose(losses, losses_j, rtol=1e-5,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(logits0, logits0_j, rtol=1e-5,
                                   atol=1e-5 * np.abs(logits0_j).max())
        np.testing.assert_allclose(logits, logits_j, rtol=1e-4,
                                   atol=1e-4 * np.abs(logits_j).max())
        for lj, lt in zip(grads_flat["layers"], grads["layers"]):
            for k in lj:
                ref = np.asarray(lj[k])
                np.testing.assert_allclose(
                    lt[k], ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(),
                    err_msg=f"grad {k} rank {rank}")
        _tree_close(p_j, params, rtol=1e-3, atol=3e-4)
    # every rank holds the same replica
    for other in port[kind][1:]:
        _tree_close(port[kind][0][1], other[1], rtol=0, atol=0)


def test_sharded_step_bf16_halo_matches_jax(port):
    losses_j, _, _, logits0_j = _jax_sharded("sage",
                                             halo_dtype=jnp.bfloat16)
    for losses, _, _, _, logits0 in port["sage_bf16"]:
        np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
        np.testing.assert_allclose(logits0, logits0_j, rtol=1e-5,
                                   atol=1e-5 * np.abs(logits0_j).max())


def test_sharded_gat_through_k4_plain_walk(port):
    """Interior edges through K4's plain walk and the hybrid merge give
    the segment-only sharded GAT within the GAT kernels' 4e-3."""
    for (lk, _, outk, gk, _), (ls, _, outs, gs, _) in zip(
            port["gat_tiles"], port["gat"]):
        np.testing.assert_allclose(lk, ls, rtol=4e-3)
        np.testing.assert_allclose(outk, outs, rtol=4e-3,
                                   atol=4e-3 * np.abs(outs).max())
        for la, lb in zip(gk["layers"], gs["layers"]):
            for k in la:
                np.testing.assert_allclose(la[k], lb[k], rtol=4e-3,
                                           atol=4e-3 * np.abs(lb[k]).max())


def test_sharded_gcn_dropout_trains(port):
    """Dropout 0.5, each rank its own stream: the loss stays finite and
    falls; the ranks agree on it."""
    runs = port["gcn_dropout"]
    losses = runs[0][0]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    for other in runs[1:]:
        assert other[0] == losses
