"""The port's ultra-wide IST path against the JAX package: host
dispatch/merge, the sequential burst and the two trainers.

Burst and trainer losses agree to rtol 1e-4 (atol 1e-5 on parameters):
Adam's m/sqrt(v) amplifies last-bit summation differences over steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gist_tpu.data.container import Dataset as JDataset
from gist_tpu.data.synthetic import synthetic_dataset as jax_synth
from gist_tpu.ist import ultrawide as JU
from gist_tpu.models import sage as jsage
from gist_tpu.sampler import ClusterSampler as JSampler
from gist_tpu.train.cluster import train_cluster_gcn as j_cluster
from gist_tpu.train.common import TrainConfig as JTC
from gist_tpu.train.ist_cluster import _RoundCollector as JCollector
from gist_tpu.train.ist_cluster import _stack_batches
from gist_tpu.train.ist_ultrawide import train_ist_ultrawide as j_uw

from gist_tpu_torch.convert import params_from_jax, params_to_numpy
from gist_tpu_torch.data import load_dataset
from gist_tpu_torch.data.container import Dataset as TDataset
from gist_tpu_torch.ist import ultrawide as TU
from gist_tpu_torch.ist.partition import VIRTUAL_IDX, boundary_sizes
from gist_tpu_torch.models import sage as tsage
from gist_tpu_torch.ops import spmm as TS
from gist_tpu_torch.sampler import ClusterSampler as TSampler
from gist_tpu_torch.train.cluster import train_cluster_gcn as t_cluster
from gist_tpu_torch.train.common import TrainConfig as TTC
from gist_tpu_torch.train.ist_cluster import _batches_to_device
from gist_tpu_torch.train.ist_cluster import _RoundCollector as TCollector
from gist_tpu_torch.train.ist_ultrawide import train_ist_ultrawide as t_uw
from torch_port_helpers import load_jax_partitioner


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _trees_close(a, b, **tol):
    for la, lb in zip(a["layers"], b["layers"]):
        assert la.keys() == lb.keys()
        for k in la:
            np.testing.assert_allclose(np.asarray(lb[k]), np.asarray(la[k]),
                                       err_msg=k, **tol)


@pytest.mark.parametrize("hidden,k", [(24, 4), (20, 3)])
def test_host_dispatch_merge_equal(hidden, k):
    """Boundary sampling, dispatch and merge, including non-divisible
    widths (VIRTUAL_IDX padding)."""
    cfg = jsage.SAGEConfig(10, hidden, 5, n_layers=3)
    full = _np_tree(jsage.init(jax.random.PRNGKey(0), cfg))
    sizes = boundary_sizes(10, hidden, 3, split_input=False,
                           split_output=True)
    bj = JU.sample_boundaries_host(np.random.default_rng(7), sizes, k)
    bt = TU.sample_boundaries_host(np.random.default_rng(7), sizes, k)
    for a, b in zip(bj, bt):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert (hidden % k != 0) == any(
        (b == VIRTUAL_IDX).any() for b in bt if b is not None)
    dj = JU.dispatch_host(full, bj, k)
    dt = TU.dispatch_host(full, bt, k)
    _trees_close(dj, dt, rtol=0, atol=0)
    trained = jax.tree.map(lambda a: a + 1.0, dj)
    mj = JU.merge_host(_np_tree(full), bj, trained, k)
    mt = TU.merge_host(_np_tree(full), bt, trained, k)
    _trees_close(mj, mt, rtol=0, atol=0)


@pytest.fixture(scope="module")
def cora_like():
    ds = jax_synth("synth-cora")
    train = np.random.default_rng(5).random(ds.n_nodes) < 0.9
    arrays = dict(name=ds.name, senders=ds.senders, receivers=ds.receivers,
                  features=ds.features, labels=ds.labels, train_mask=train,
                  val_mask=~train, test_mask=~train, n_classes=ds.n_classes)
    return JDataset(**arrays), TDataset(**arrays)


def test_burst_parity(cora_like, monkeypatch):
    """Sequential bursts from the same sub-parameters on three tiles=True
    batches: JAX on its segment path, the port on K1's plain walk."""
    jd, td = cora_like
    k = 2
    jcfg = jsage.SAGEConfig(jd.in_feats, 32, jd.n_classes, n_layers=2,
                            dropout=0.0)
    tcfg = tsage.SAGEConfig(jd.in_feats, 32, jd.n_classes, n_layers=2,
                            dropout=0.0)
    sizes = boundary_sizes(jd.in_feats, 32, 2, split_input=False,
                           split_output=True)
    bnds = JU.sample_boundaries_host(np.random.default_rng(1), sizes, k)
    full = _np_tree(jsage.init(jax.random.PRNGKey(0), jcfg))
    shard = jax.tree.map(lambda a: a[1], JU.dispatch_host(full, bnds, k))

    js = JSampler(jd, 8, 2, seed=3, tiles=True)
    ts = TSampler(td, 8, 2, seed=3, tiles=True)
    jb = _stack_batches(JCollector(js, 3, ids_only=True).collect())
    tb = _batches_to_device(TCollector(ts, 3, ids_only=True).collect(), "cpu")
    assert all(b.graph.dedup is not None for b in tb)

    jburst = JU.build_local_burst_single(
        jsage, jcfg.sub_config(split_input=False, split_output=True,
                               num_subnet=k), weight_decay=5e-4)
    jsub, jl = jburst(jax.tree.map(jnp.asarray, shard), jb, jnp.asarray(1e-2),
                      jax.random.PRNGKey(0), jnp.asarray(1), js.tables())

    monkeypatch.setattr(TS, "_DEFAULT_BACKEND", "dedup")
    tburst = TU.build_local_burst_single(
        tsage, tcfg.sub_config(split_input=False, split_output=True,
                               num_subnet=k), weight_decay=5e-4)
    tsub, tl = tburst(params_from_jax(shard), tb, 1e-2, None, ts.tables())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    _trees_close(_np_tree(jsub), params_to_numpy(tsub), rtol=1e-4,
                 atol=1e-5)


def _tiny_cfgs():
    ds = load_dataset("synth-tiny")
    args = (ds.in_feats, 16, ds.n_classes)
    return (jsage.SAGEConfig(*args, n_layers=2, dropout=0.0),
            tsage.SAGEConfig(*args, n_layers=2, dropout=0.0))


def test_ultrawide_trainer_parity():
    jcfg, tcfg = _tiny_cfgs()
    kw = dict(lr=1e-2, weight_decay=5e-4, n_epochs=4, num_subnet=2,
              iter_per_site=2)
    init = _np_tree(jsage.init(jax.random.PRNGKey(0), jcfg))
    common = dict(psize=4, batch_size=2, use_f1=True, normalize=True,
                  verbose=False)
    rj = j_uw(jax_synth("synth-tiny"), jcfg, JTC(**kw), sequential=True,
              **common)
    rt = t_uw(load_dataset("synth-tiny"), tcfg, TTC(**kw), init_params=init,
              device="cpu", **common)
    assert len(rj["losses"]) == len(rt["losses"]) == 2
    np.testing.assert_allclose(rt["losses"], rj["losses"], rtol=1e-4)
    assert rt["val_accs"][-1] == rj["val_accs"][-1]


def test_cluster_gcn_trainer_parity():
    jcfg, tcfg = _tiny_cfgs()
    kw = dict(lr=1e-2, weight_decay=5e-4, n_epochs=2)
    init = _np_tree(jsage.init(jax.random.PRNGKey(0), jcfg))
    common = dict(psize=4, batch_size=2, verbose=False)
    rj = j_cluster(jax_synth("synth-tiny"), jcfg, JTC(**kw), **common)
    rt = t_cluster(load_dataset("synth-tiny"), tcfg, TTC(**kw),
                   init_params=init, device="cpu", **common)
    np.testing.assert_allclose(rt["losses"], rj["losses"], rtol=1e-4)
    assert rt["val_accs"][-1] == rj["val_accs"][-1]


def test_unported_modes_raise():
    _, tcfg = _tiny_cfgs()
    ds = load_dataset("synth-tiny")
    with pytest.raises(NotImplementedError, match="distributed"):
        t_uw(ds, tcfg, TTC(num_subnet=2), sequential=False, device="cpu")
    with pytest.raises(NotImplementedError, match="use_pp"):
        t_uw(ds, tcfg, TTC(num_subnet=2), use_pp=True, device="cpu")


def test_train_common_matches(tmp_path):
    from gist_tpu.train.common import reference_lr_schedule as j_lr

    from gist_tpu_torch.train.common import reference_lr_schedule as t_lr
    from gist_tpu_torch.train.common import write_results
    for epoch in range(0, 40, 3):
        assert t_lr(0.1, 40, epoch) == j_lr(0.1, 40, epoch)
    path = tmp_path / "r" / "out.json"
    write_results({"losses": [1.5, 1.25]}, str(path))
    import json
    rec = json.loads(path.read_text())
    assert rec["losses"] == [1.5, 1.25]
    from gist_tpu_torch.utils import hardware_tag
    assert rec["hardware"] == hardware_tag()
    assert TTC() == TTC(**{k: getattr(JTC(), k)
                           for k in JTC.__dataclass_fields__})
