"""The port's IST over a ``subnet`` mesh against the JAX package, in a
gloo world of two CPU ranks: ``build_ist_round`` (GCN and SAGE on
full-graph batches), ``run_distributed_ist``, ``train_ist_cluster`` with
a mesh (SAGE, GCN, GAT, the local-SGD baseline) and
``train_ist_ultrawide(sequential=False)``, each against the JAX
function on the 8-device CPU mesh with the same initial params and
boundaries, at dropout 0.  The ultra-wide mesh run is also held against
the port's own sequential mode.

The cluster trainer's batches carry dedup layouts (backend ``dedup``,
``TILES_MIN_EDGES`` 0 in the ranks), so its steps run the plain K1 and
K4-K6 walks.  Round results agree to 1e-5 relative; trainer loss
curves to the 1e-4 the single-card trainer tests use (summation order,
amplified by Adam over steps), accuracies to one node."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gist_tpu.graph as G
from gist_tpu.data.synthetic import synthetic_dataset as jax_synth
from gist_tpu.ist import partition as JPart
from gist_tpu.ist.distributed import build_ist_round as j_round
from gist_tpu.ist.distributed import make_subnet_mesh as j_mesh
from gist_tpu.ist.distributed import run_distributed_ist as j_run
from gist_tpu.models import gat as jgat
from gist_tpu.models import gcn as jgcn
from gist_tpu.models import sage as jsage
from gist_tpu.train.common import TrainConfig as JTC
from gist_tpu.train.ist_cluster import train_ist_cluster as j_cluster
from gist_tpu.train.ist_ultrawide import train_ist_ultrawide as j_uw

from gist_tpu_torch.models import gat as tgat
from gist_tpu_torch.models import gcn as tgcn
from gist_tpu_torch.models import sage as tsage
from torch_dist_workers import run_world
from torch_port_helpers import load_jax_partitioner

K = 2
HIDDEN = 16


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _tiny():
    return jax_synth("synth-tiny")


def _round_setup(kind):
    ds = _tiny()
    jm, tm = (jgcn, tgcn) if kind == "gcn" else (jsage, tsage)
    args = (ds.in_feats, HIDDEN, ds.n_classes)
    jcfg = (jgcn.GCNConfig if kind == "gcn" else jsage.SAGEConfig)(
        *args, n_layers=2, dropout=0.0)
    tcfg = (tgcn.GCNConfig if kind == "gcn" else tsage.SAGEConfig)(
        *args, n_layers=2, dropout=0.0)
    init = _np_tree(jm.init(jax.random.PRNGKey(0), jcfg))
    sizes = JPart.boundary_sizes(ds.in_feats, HIDDEN, 2, split_input=False,
                                 split_output=True)
    bnds = JPart.sample_boundaries(jax.random.PRNGKey(5), sizes, K)
    return ds, jm, jcfg, tcfg, init, [None if b is None else np.asarray(b)
                                      for b in bnds]


def _jax_round(kind):
    ds, jm, jcfg, _, init, bnds = _round_setup(kind)
    sub_cfg = jcfg.sub_config(split_input=False, split_output=True,
                              num_subnet=K)
    fn = j_round(jm, sub_cfg, mesh=j_mesh(K), kind=kind, num_subnet=K,
                 weight_decay=5e-4, split_input=False)
    g = G.graph_from_edges(ds.senders, ds.receivers, ds.n_nodes)
    batch = (g, jnp.asarray(ds.features), jnp.asarray(ds.labels),
             jnp.asarray(ds.train_mask))
    batches = jax.tree.map(lambda a: jnp.broadcast_to(a, (3,) + a.shape),
                           batch)
    full, losses = fn(jax.tree.map(jnp.asarray, init),
                      [None if b is None else jnp.asarray(b) for b in bnds],
                      batches, jnp.asarray(1e-2), jax.random.PRNGKey(1),
                      None)
    return _np_tree(full), np.asarray(losses)


def _run_setup():
    ds = _tiny()
    cfg_args = (ds.in_feats, HIDDEN, ds.n_classes)
    jcfg = jgcn.GCNConfig(*cfg_args, n_layers=2, dropout=0.0)
    tcfg = tgcn.GCNConfig(*cfg_args, n_layers=2, dropout=0.0)
    tc = dict(lr=1e-2, weight_decay=5e-4, n_epochs=6, num_subnet=K,
              iter_per_site=2)
    return ds, jcfg, tcfg, tc


def _cluster_case(kind, lsgd=False):
    """The JAX trainer's run and what the port's ranks need to repeat
    it: the port config, the initial params and the per-round
    boundaries the JAX trainer drew."""
    ds = _tiny()
    kw = dict(lr=1e-2, weight_decay=5e-4, n_epochs=4, num_subnet=K,
              iter_per_site=2)
    if kind == "gat":
        args = dict(in_feats=ds.in_feats, n_hidden=HIDDEN,
                    n_classes=ds.n_classes, n_layers=2, n_heads=2)
        jcfg, tcfg, jm = jgat.GATConfig(**args), tgat.GATConfig(**args), jgat
        sizes = [None, HIDDEN, None]
    else:
        args = (ds.in_feats, HIDDEN, ds.n_classes)
        if kind == "gcn":
            jcfg = jgcn.GCNConfig(*args, n_layers=2, dropout=0.0)
            tcfg, jm = tgcn.GCNConfig(*args, n_layers=2, dropout=0.0), jgcn
        else:
            jcfg = jsage.SAGEConfig(*args, n_layers=2, dropout=0.0)
            tcfg, jm = tsage.SAGEConfig(*args, n_layers=2, dropout=0.0), jsage
        sizes = JPart.boundary_sizes(ds.in_feats, HIDDEN, 2,
                                     split_input=False, split_output=True)
    if lsgd:
        sizes = [None] * (len(sizes) + 1)
    common = dict(psize=4, batch_size=2, normalize=True, verbose=False,
                  lsgd=lsgd)
    rj = j_cluster(_tiny(), jcfg, JTC(**kw), model=jm, kind=kind, **common)
    key, rounds = jax.random.PRNGKey(JTC().seed + 1), []
    for _ in range(len(rj["losses"])):
        key, sk = jax.random.split(key)
        rounds.append([None if b is None else np.asarray(b)
                       for b in JPart.sample_boundaries(sk, sizes, K)])
    case = dict(kind=kind, cfg=tcfg, tc=kw, common=common, rounds=rounds,
                init=_np_tree(jm.init(jax.random.PRNGKey(0), jcfg)))
    return rj, case


def _uw_case():
    ds = _tiny()
    args = (ds.in_feats, HIDDEN, ds.n_classes)
    jcfg = jsage.SAGEConfig(*args, n_layers=2, dropout=0.0)
    tcfg = tsage.SAGEConfig(*args, n_layers=2, dropout=0.0)
    kw = dict(lr=1e-2, weight_decay=5e-4, n_epochs=4, num_subnet=K,
              iter_per_site=2)
    common = dict(psize=4, batch_size=2, normalize=True, verbose=False)
    init = _np_tree(jsage.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, kw, common, init, dict(cfg=tcfg, tc=kw, common=common,
                                        init=init)


CLUSTER = {"cluster_sage": ("sage", False), "cluster_gcn": ("gcn", False),
           "cluster_gat": ("gat", False), "cluster_lsgd": ("sage", True)}


@pytest.fixture(scope="module")
def runs():
    """The JAX side of every case, and one gloo world of K ranks running
    the port's side of all of them."""
    jax_side, payload, cases = {}, {}, []
    init, bnds, cfgs = {}, {}, {}
    for kind in ("gcn", "sage"):
        _, _, _, tcfg, init[kind], bnds[kind] = _round_setup(kind)
        cfgs[kind] = tcfg
        d = _tiny()
        payload["round"] = dict(s=d.senders, r=d.receivers, n=d.n_nodes,
                                x=d.features, labels=d.labels,
                                mask=d.train_mask)
        jax_side[f"round_{kind}"] = _jax_round(kind)
        cases.append((f"round_{kind}", dict(fn="ist_round", kind=kind)))
    payload.update(init=init, bnds=bnds, cfg=cfgs)

    ds, jcfg, tcfg, tc = _run_setup()
    run_init = _np_tree(jgcn.init(jax.random.PRNGKey(JTC().seed), jcfg))
    jax_side["run"] = j_run(ds, jcfg, JTC(**tc), model=jgcn, kind="gcn",
                            mesh=j_mesh(K), verbose=False)
    sizes = JPart.boundary_sizes(ds.in_feats, HIDDEN, 2, split_input=False,
                                 split_output=False)
    key, run_bnds = jax.random.PRNGKey(JTC().seed + 1), []
    for _ in range(len(jax_side["run"]["losses"])):
        key, sk = jax.random.split(key)
        run_bnds.append([None if b is None else np.asarray(b)
                         for b in JPart.sample_boundaries(sk, sizes, K)])
    payload.update(run_cfg=tcfg, run_tc=tc, run_init=run_init,
                   run_bnds=run_bnds)
    cases.append(("run", dict(fn="run_ist")))

    for name, (kind, lsgd) in CLUSTER.items():
        jax_side[name], payload[name] = _cluster_case(kind, lsgd)
        cases.append((name, dict(fn="ist_cluster", case=name)))

    jcfg, kw, common, _, payload["uw"] = _uw_case()
    jax_side["uw"] = j_uw(_tiny(), jcfg, JTC(**kw), mesh=j_mesh(K),
                          sequential=False, **common)
    cases.append(("uw_mesh", dict(fn="ist_ultrawide", sequential=False)))
    cases.append(("uw_seq", dict(fn="ist_ultrawide", sequential=True)))
    return jax_side, run_world(K, cases, payload, timeout_s=120)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_build_ist_round_matches_jax(runs, kind):
    jax_side, port = runs
    full_j, losses_j = jax_side[f"round_{kind}"]
    for rank, (full, losses) in enumerate(port[f"round_{kind}"]):
        assert losses.shape == losses_j.shape == (K, 3)
        np.testing.assert_allclose(losses, losses_j, rtol=1e-5,
                                   err_msg=f"rank {rank}")
        for lj, lt in zip(full_j["layers"], full["layers"]):
            for k in lj:
                np.testing.assert_allclose(lt[k], lj[k], rtol=1e-5,
                                           atol=1e-5, err_msg=k)


def test_run_distributed_ist_matches_jax(runs):
    jax_side, port = runs
    rj = jax_side["run"]
    for rt in port["run"]:
        assert len(rt["losses"]) == len(rj["losses"]) == 3
        np.testing.assert_allclose(rt["losses"], rj["losses"], rtol=1e-5)
        n_val = int(_tiny().val_mask.sum())
        np.testing.assert_allclose(rt["val_accs"], rj["val_accs"],
                                   atol=1.0 / n_val + 1e-9)


@pytest.mark.parametrize("name", list(CLUSTER))
def test_train_ist_cluster_mesh_matches_jax(runs, name):
    jax_side, port = runs
    rj = jax_side[name]
    ds = _tiny()
    for rt in port[name]:
        assert len(rt["losses"]) == len(rj["losses"]) == 2
        np.testing.assert_allclose(rt["losses"], rj["losses"], rtol=1e-4)
        np.testing.assert_allclose(rt["val_accs"], rj["val_accs"],
                                   atol=1.0 / int(ds.val_mask.sum()) + 1e-9)
        np.testing.assert_allclose(rt["test_accs"], rj["test_accs"],
                                   atol=1.0 / int(ds.test_mask.sum()) + 1e-9)
    # every rank returns rank 0's results
    assert port[name][0]["val_accs"] == port[name][1]["val_accs"]
    assert port[name][0]["losses"] == port[name][1]["losses"]


def test_train_ist_ultrawide_mesh_matches_jax_and_sequential(runs):
    jax_side, port = runs
    rj = jax_side["uw"]
    for mesh_run, seq_run in zip(port["uw_mesh"], port["uw_seq"]):
        np.testing.assert_allclose(mesh_run["losses"], rj["losses"],
                                   rtol=1e-4)
        np.testing.assert_allclose(mesh_run["losses"], seq_run["losses"],
                                   rtol=1e-5)
        assert mesh_run["val_accs"] == seq_run["val_accs"]
        assert mesh_run["val_accs"] == pytest.approx(rj["val_accs"],
                                                     abs=1e-2)
