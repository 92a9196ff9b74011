"""The port's IST on the 2-D ("subnet", "graph") mesh against the JAX
package: ``build_ist_sharded_round`` for SAGE, GCN and GAT in a gloo
world of four CPU ranks (2 subnets x 2 graph shards) against JAX's
round on a (2, 2) mesh of the 8-device CPU mesh, from the same initial
params and boundaries: losses within 1e-5 relative, the merged params
within 1e-4 (three Adam steps of lr 1e-2 amplify last-bit differences
of near-zero gradients to ~2e-5).
The JAX round returns one subnet's losses (its ``P()`` out spec); the
port returns every subnet's, and its first row is JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gist_tpu.data import synthetic_dataset
from gist_tpu.ist.partition import boundary_sizes, sample_boundaries
from gist_tpu.models import gat as jgat
from gist_tpu.models import gcn as jgcn
from gist_tpu.models import sage as jsage
from gist_tpu.parallel import build_sharded_graph
from gist_tpu.parallel.graph_shard import shard_features
from gist_tpu.parallel.ist_sharded import (build_ist_sharded_round,
                                           make_ist_graph_mesh)

from torch_dist_workers import run_world
from torch_port_helpers import load_jax_partitioner

S, GD = 2, 2
KINDS = ("sage", "gcn", "gat")


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _setup(kind):
    ds = synthetic_dataset("synth-tiny")
    if kind == "gat":
        m = jgat
        cfg = jgat.GATConfig(ds.in_feats, 16, ds.n_classes, n_layers=2,
                             n_heads=2)
    else:
        m = jsage if kind == "sage" else jgcn
        cfg = (jsage.SAGEConfig if kind == "sage" else jgcn.GCNConfig)(
            ds.in_feats, 16, ds.n_classes, n_layers=2, dropout=0.0)
    init = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0), cfg))
    sizes = boundary_sizes(cfg.in_feats, cfg.n_hidden, cfg.n_layers,
                           split_input=False, split_output=kind != "gat")
    bnds = [None if b is None else np.asarray(b) for b in
            sample_boundaries(jax.random.PRNGKey(4), sizes, S)]
    return ds, init, bnds


def _jax_round(kind):
    ds, init, bnds = _setup(kind)
    mesh = make_ist_graph_mesh(S, GD)
    sg = build_sharded_graph(ds.senders, ds.receivers, ds.n_nodes, GD)
    perm = np.asarray(sg.node_perm)
    lab = np.zeros(sg.total_rows, np.int32)
    lab[perm] = ds.labels
    msk = np.zeros(sg.total_rows, bool)
    msk[perm] = ds.train_mask
    fn = build_ist_sharded_round(sg, mesh, num_subnet=S, kind=kind,
                                 n_steps=3)
    full, losses = fn(jax.tree.map(jnp.asarray, init),
                      [None if b is None else jnp.asarray(b) for b in bnds],
                      shard_features(sg, ds.features, mesh),
                      jnp.asarray(lab), jnp.asarray(msk), jnp.asarray(1e-2),
                      jax.random.PRNGKey(1))
    return jax.tree.map(np.asarray, full), np.asarray(losses)


@pytest.fixture(scope="module")
def port():
    ds = synthetic_dataset("synth-tiny")
    payload = {"ds": dict(s=ds.senders, r=ds.receivers, n=ds.n_nodes,
                          x=ds.features, labels=ds.labels,
                          mask=ds.train_mask),
               "init": {}, "bnds2d": {}}
    for kind in KINDS:
        _, payload["init"][kind], payload["bnds2d"][kind] = _setup(kind)
    return run_world(S * GD, [(k, dict(fn="ist_sharded", kind=k,
                                       n_subnet=S)) for k in KINDS],
                     payload, timeout_s=120)


@pytest.mark.parametrize("kind", KINDS)
def test_ist_sharded_round_matches_jax(port, kind):
    full_j, losses_j = _jax_round(kind)
    assert losses_j.shape == (1, 3)
    for rank, (full, losses) in enumerate(port[kind]):
        assert losses.shape == (S, 3)
        np.testing.assert_allclose(losses[:1], losses_j, rtol=1e-5,
                                   err_msg=f"rank {rank}")
        for lj, lt in zip(full_j["layers"], full["layers"]):
            for k in lj:
                np.testing.assert_allclose(lt[k], lj[k], rtol=1e-4,
                                           atol=1e-4,
                                           err_msg=f"{k} rank {rank}")
    # every rank merges the same full-width params
    for other in port[kind][1:]:
        for la, lb in zip(port[kind][0][0]["layers"], other[0]["layers"]):
            for k in la:
                np.testing.assert_array_equal(la[k], lb[k])
