"""The port's IST cluster path against the JAX package: boundary
partitions, device dispatch/merge for gcn, sage and gat, the host
dispatch/merge of gat, and ``train_ist_cluster`` (kind gat and sage)
against the JAX trainer on the 8-device CPU mesh.

``jax.random`` and torch draw different partitions, so the trainer tests
inject the JAX trainer's per-round boundaries into the port.  The port
runs with backend ``dedup`` and a layout on every batch, so its steps go
through the plain K4–K6; the JAX trainer takes its segment path.  Losses
agree to rtol 1e-4 (summation order, amplified by Adam over steps) and
accuracies to one validation node."""

import jax
import numpy as np
import pytest
import torch

from gist_tpu.data.synthetic import synthetic_dataset as jax_synth
from gist_tpu.ist import partition as JPart
from gist_tpu.ist import slicing as JSl
from gist_tpu.ist import ultrawide as JU
from gist_tpu.models import gat as jgat
from gist_tpu.models import sage as jsage
from gist_tpu.train.common import TrainConfig as JTC
from gist_tpu.train.ist_cluster import train_ist_cluster as j_train

from gist_tpu_torch import sampler as TSampler
from gist_tpu_torch.data import load_dataset
from gist_tpu_torch.ist import partition as TPart
from gist_tpu_torch.ist import slicing as TSl
from gist_tpu_torch.ist import ultrawide as TU
from gist_tpu_torch.models import gat as tgat
from gist_tpu_torch.models import sage as tsage
from gist_tpu_torch.ops import gat_dedup
from gist_tpu_torch.ops import spmm as TS
from gist_tpu_torch.train import ist_cluster as TIC
from gist_tpu_torch.train.common import TrainConfig as TTC
from torch_port_helpers import load_jax_partitioner


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _to_torch(bnds):
    return [None if b is None else torch.from_numpy(np.array(b)).long()
            for b in bnds]


def _close(a, b, atol=0.0):
    for la, lb in zip(a["layers"], b["layers"]):
        assert la.keys() == lb.keys()
        for k in la:
            np.testing.assert_allclose(np.asarray(lb[k]), np.asarray(la[k]),
                                       rtol=0, atol=atol, err_msg=k)


def _model(kind, hidden):
    if kind == "gat":
        cfg = jgat.GATConfig(12, hidden, 5, n_layers=3, n_heads=2)
        return jgat.init(jax.random.PRNGKey(0), cfg), [None, hidden,
                                                        hidden, None]
    cfg = jsage.SAGEConfig(12, hidden, 5, n_layers=3)
    init = jsage.init(jax.random.PRNGKey(0), cfg)
    sizes = JPart.boundary_sizes(12, hidden, 3, split_input=kind == "gcn",
                                 split_output=True)
    if kind == "gcn":   # gcn rows index the (in, out) weight directly
        init = jax.tree.map(lambda a: a, init)
        for layer in init["layers"]:
            layer["w"] = layer["w"][:layer["w"].shape[0] // 2]
    return init, sizes


@pytest.mark.parametrize("kind", ["gcn", "sage", "gat"])
@pytest.mark.parametrize("hidden,k", [(24, 4), (20, 3)])
def test_dispatch_merge_match_jax(kind, hidden, k):
    """dispatch, dispatch_all and merge, including non-divisible widths
    (VIRTUAL_IDX padding read as zero, dropped at merge)."""
    full, sizes = _model(kind, hidden)
    bj = JPart.sample_boundaries(jax.random.PRNGKey(7), sizes, k)
    bt = _to_torch(bj)
    assert (hidden % k != 0) == any(
        bool((b == TPart.VIRTUAL_IDX).any()) for b in bt if b is not None)
    full_t = {"layers": [{kk: torch.from_numpy(np.array(v))
                          for kk, v in l.items()} for l in full["layers"]]}
    for s in range(k):
        _close(_np_tree(JSl.dispatch(full, bj, s, kind)),
               {"layers": [{kk: v.numpy() for kk, v in l.items()}
                           for l in TSl.dispatch(full_t, bt, s,
                                                 kind)["layers"]]})
    stacked_j = JSl.dispatch_all(full, bj, k, kind)
    stacked_t = TSl.dispatch_all(full_t, bt, k, kind)
    _close(_np_tree(stacked_j), {"layers": [
        {kk: v.numpy() for kk, v in l.items()} for l in stacked_t["layers"]]})
    trained_j = jax.tree.map(lambda a: a * 1.5 + 1.0, stacked_j)
    trained_t = {"layers": [{kk: v * 1.5 + 1.0 for kk, v in l.items()}
                            for l in stacked_t["layers"]]}
    merged_t = TSl.merge(full_t, bt, trained_t, k, kind)
    _close(_np_tree(JSl.merge(full, bj, trained_j, k, kind)),
           {"layers": [{kk: v.numpy() for kk, v in l.items()}
                       for l in merged_t["layers"]]}, atol=1e-6)
    # dispatch hands out fresh tensors: training a shard in place leaves
    # the full-width parameters alone
    sub = TSl.dispatch(full_t, bt, 0, kind)
    for layer in sub["layers"]:
        for v in layer.values():
            v.add_(1.0)
    _close(_np_tree(full), {"layers": [
        {kk: v.numpy() for kk, v in l.items()} for l in full_t["layers"]]})


@pytest.mark.parametrize("hidden,k", [(24, 4), (20, 3)])
def test_host_dispatch_merge_gat(hidden, k):
    full, sizes = _model("gat", hidden)
    full = _np_tree(full)
    bnds = JU.sample_boundaries_host(np.random.default_rng(3), sizes, k)
    dj = JU.dispatch_host(full, bnds, k, kind="gat")
    dt = TU.dispatch_host(full, bnds, k, kind="gat")
    _close(dj, dt)
    trained = jax.tree.map(lambda a: a - 2.0, dj)
    _close(JU.merge_host(_np_tree(full), bnds, trained, k, kind="gat"),
           TU.merge_host(_np_tree(full), bnds, trained, k, kind="gat"))


def test_sample_boundaries_partition():
    g = torch.Generator().manual_seed(0)
    bnds = TPart.sample_boundaries(g, [None, 10, 12], 3)
    assert bnds[0] is None and bnds[1].shape == (3, 4)
    b = bnds[1].flatten()
    assert sorted(b[b < 10].tolist()) == list(range(10))
    assert int((b == TPart.VIRTUAL_IDX).sum()) == 2
    assert sorted(bnds[2].flatten().tolist()) == list(range(12))


def _run_both(kind, monkeypatch):
    k, hidden = 2, 16
    kw = dict(lr=1e-2, weight_decay=5e-4, n_epochs=4, num_subnet=k,
              iter_per_site=2)
    ds_t = load_dataset("synth-tiny")
    if kind == "gat":
        args = dict(in_feats=ds_t.in_feats, n_hidden=hidden,
                    n_classes=ds_t.n_classes, n_layers=2, n_heads=2)
        jcfg, tcfg, jm, tm = (jgat.GATConfig(**args), tgat.GATConfig(**args),
                              jgat, tgat)
        sizes = [None, hidden, None]
    else:
        args = (ds_t.in_feats, hidden, ds_t.n_classes)
        jcfg = jsage.SAGEConfig(*args, n_layers=2, dropout=0.0)
        tcfg = tsage.SAGEConfig(*args, n_layers=2, dropout=0.0)
        jm, tm = jsage, tsage
        sizes = JPart.boundary_sizes(ds_t.in_feats, hidden, 2,
                                     split_input=False, split_output=True)
    common = dict(psize=4, batch_size=2, normalize=True, verbose=False)
    rj = j_train(jax_synth("synth-tiny"), jcfg, JTC(**kw), model=jm,
                 kind=kind, **common)
    # the JAX trainer's boundaries: one split of its partition key a round
    key, rounds = jax.random.PRNGKey(JTC().seed + 1), []
    for _ in range(len(rj["losses"])):
        key, sk = jax.random.split(key)
        rounds.append(_to_torch(JPart.sample_boundaries(sk, sizes, k)))
    monkeypatch.setattr(TIC, "sample_boundaries",
                        lambda gen, sz, kk: rounds.pop(0))
    monkeypatch.setattr(TS, "_DEFAULT_BACKEND", "dedup")
    monkeypatch.setattr(TSampler, "TILES_MIN_EDGES", 0)
    init = _np_tree(jm.init(jax.random.PRNGKey(0), jcfg))
    gat_dedup.reset_launches()
    walks = {}
    for name in ("gat_fwd_reference", "gat_bwd_b1_reference",
                 "gat_bwd_b2_reference"):
        def spy(*a, _f=getattr(gat_dedup, name), _n=name):
            walks[_n] = walks.get(_n, 0) + 1
            return _f(*a)
        monkeypatch.setattr(gat_dedup, name, spy)
    rt = TIC.train_ist_cluster(ds_t, tcfg, TTC(**kw), model=tm, kind=kind,
                               init_params=init, device="cpu", **common)
    assert not rounds
    return rj, rt, ds_t, walks


@pytest.mark.parametrize("kind", ["gat", "sage"])
def test_train_ist_cluster_matches_jax(kind, monkeypatch):
    rj, rt, ds, walks = _run_both(kind, monkeypatch)
    # 2 rounds x 2 subnets x 2 steps, each through the plain K4-K6 walks:
    # K4 once per layer, K5 and K6 once per head (2 + 1)
    assert walks == ({} if kind == "sage" else {
        "gat_fwd_reference": 16, "gat_bwd_b1_reference": 24,
        "gat_bwd_b2_reference": 24})
    assert len(rj["losses"]) == len(rt["losses"]) == 2
    assert len(rt["val_accs"]) == len(rj["val_accs"])
    np.testing.assert_allclose(rt["losses"], rj["losses"], rtol=1e-4)
    n_val = int(ds.val_mask.sum())
    np.testing.assert_allclose(rt["val_accs"], rj["val_accs"],
                               atol=1.0 / n_val + 1e-9)
    np.testing.assert_allclose(rt["test_accs"], rj["test_accs"],
                               atol=1.0 / int(ds.test_mask.sum()) + 1e-9)
    for key in ("train_time", "edges_per_sec", "eval_times",
                "edges_per_batch"):
        assert key in rt
    # no launches on the CPU: the steps ran the plain K4-K6 walks
    assert (gat_dedup.launches_fwd, gat_dedup.launches_b1,
            gat_dedup.launches_b2) == (0, 0, 0)


def test_train_ist_cluster_unported_modes_raise():
    ds = load_dataset("synth-tiny")
    cfg = tgat.GATConfig(ds.in_feats, 8, ds.n_classes)
    for kw, match in ((dict(mesh=object()), "distributed"),
                      (dict(lsgd=True), "distributed"),
                      (dict(use_pp=True), "use_pp"),
                      (dict(kind="gcn"), "gcn")):
        with pytest.raises(NotImplementedError, match=match):
            TIC.train_ist_cluster(ds, cfg, TTC(num_subnet=2), model=tgat,
                                  **{"kind": "gat", **kw}, device="cpu")
