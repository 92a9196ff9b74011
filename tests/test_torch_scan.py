"""The port's epoch scans on the CPU against the JAX package's:
``train_cluster_gcn(scan_batches=True)`` and
``train_full_graph(scan_epochs=k)``, from the JAX initial parameters
with dropout 0 (the JAX scans draw other dropout keys than its loops).
Losses agree to 1e-4 relative (summation order: the stacked epoch pads
every batch to the round's bucket), accuracies to one validation node.
Inside the port, scan and loop agree to 1e-5.  On the CPU the stacked
epoch runs as a loop over its slices; the capture into a CUDA graph is
held on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax
import numpy as np
import pytest
import torch

from conftest import make_random_graph
from gist_tpu.data.container import Dataset as JDataset
from gist_tpu.data.synthetic import synthetic_dataset as jax_synth
from gist_tpu.models import gat as jgat
from gist_tpu.models import gcn as jgcn
from gist_tpu.models import sage as jsage
from gist_tpu.train.cluster import train_cluster_gcn as j_cluster
from gist_tpu.train.common import TrainConfig as JTC
from gist_tpu.train.full_graph import train_full_graph as j_full

import gist_tpu_torch.graph as TG
import gist_tpu_torch.sampler as TSM
from gist_tpu_torch.data import load_dataset
from gist_tpu_torch.data.container import Dataset
from gist_tpu_torch.models import gat as tgat
from gist_tpu_torch.models import gcn as tgcn
from gist_tpu_torch.models import sage as tsage
from gist_tpu_torch.ops import dedup_spmm as K
from gist_tpu_torch.ops import spmm as TS
from gist_tpu_torch.train import capture
from gist_tpu_torch.train.cluster import train_cluster_gcn as t_cluster
from gist_tpu_torch.train.common import TrainConfig as TTC
from gist_tpu_torch.train.common import make_optimizer
from gist_tpu_torch.train.full_graph import train_full_graph as t_full
from gist_tpu_torch.train.ist_cluster import _RoundCollector
from torch_port_helpers import load_jax_partitioner


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _multi_hot(ds, c=5):
    w = np.random.default_rng(1).standard_normal((ds.in_feats, c))
    ds.labels_multi = (ds.features @ w > 0).astype(np.float32)
    ds.labels = ds.labels_multi.argmax(axis=1).astype(np.int32)
    ds.n_classes = c
    return ds


def _cluster_case(model, use_pp=False, multitask=False):
    dsj, dst = jax_synth("synth-tiny"), load_dataset("synth-tiny")
    if multitask:
        dsj, dst = _multi_hot(dsj), _multi_hot(dst)
    args = (dst.in_feats, 16, dst.n_classes)
    if model == "gcn":
        mods = (jgcn, tgcn)
        cfgs = (jgcn.GCNConfig(*args, n_layers=2, dropout=0.0),
                tgcn.GCNConfig(*args, n_layers=2, dropout=0.0))
    else:
        mods = (jsage, tsage)
        cfgs = (jsage.SAGEConfig(*args, n_layers=2, dropout=0.0,
                                 use_pp=use_pp),
                tsage.SAGEConfig(*args, n_layers=2, dropout=0.0,
                                 use_pp=use_pp))
    init = _np_tree(mods[0].init(jax.random.PRNGKey(0), cfgs[0]))
    return (dsj, dst), mods, cfgs, init


def _assert_close(got, want, n_val, rtol=1e-4):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol)
    for k in ("val_accs", "test_accs"):
        np.testing.assert_allclose(got[k], want[k], atol=1.0 / n_val + 1e-7)


CLUSTER_KW = dict(lr=1e-2, weight_decay=5e-4, n_epochs=3)
CLUSTER_COMMON = dict(psize=4, batch_size=2, verbose=False)


@pytest.mark.parametrize("model,use_pp,multitask", [
    ("sage", False, False), ("sage", True, True), ("gcn", False, False)])
def test_cluster_scan_matches_jax(model, use_pp, multitask):
    (dsj, dst), (jm, tm), (jcfg, tcfg), init = _cluster_case(
        model, use_pp, multitask)
    capture.reset_stats()
    want = j_cluster(dsj, jcfg, JTC(**CLUSTER_KW), model=jm, use_pp=use_pp,
                     scan_batches=True, **CLUSTER_COMMON)
    got = t_cluster(dst, tcfg, TTC(**CLUSTER_KW), model=tm, use_pp=use_pp,
                    init_params=init, scan_batches=True, device="cpu",
                    **CLUSTER_COMMON)
    assert set(got) == set(want)
    _assert_close(got, want, int(dst.val_mask.sum()))
    assert capture.stats["captures"] == 0   # the CPU runs no capture


def test_cluster_scan_through_tiles_matches_jax(monkeypatch):
    """The port's batches forced onto the dedup layout (K1's plain walk
    on every batch and its transpose) against the JAX scan on the
    segment path."""
    (dsj, dst), (jm, tm), (jcfg, tcfg), init = _cluster_case("sage")
    want = j_cluster(dsj, jcfg, JTC(**CLUSTER_KW), model=jm,
                     scan_batches=True, **CLUSTER_COMMON)
    walks = []
    real = K.dedup_spmm_reference

    def spy(*a, **k):
        walks.append(1)
        return real(*a, **k)
    monkeypatch.setattr(K, "dedup_spmm_reference", spy)
    # every batch gets the layout, and a graph that carries one takes the
    # kernel route, as "auto" does on a card (the full-graph eval keeps
    # the segment path)
    monkeypatch.setattr(TSM, "TILES_MIN_EDGES", 0)
    monkeypatch.setattr(TS, "tiles_wanted", lambda: True)
    monkeypatch.setattr(TS, "resolve_backend", lambda graph=None, b=None:
                        "dedup" if graph.dedup is not None else "segment")
    got = t_cluster(dst, tcfg, TTC(**CLUSTER_KW), init_params=init,
                    scan_batches=True, device="cpu", **CLUSTER_COMMON)
    # 2 steps an epoch, 3 epochs: 3 forward walks (one a layer) and 2
    # backward (the first layer's input takes no gradient) a step
    assert len(walks) == 3 * 2 * 5
    _assert_close(got, want, int(dst.val_mask.sum()))


def test_cluster_scan_matches_loop():
    """Scan and loop draw one node-id stream; their losses differ only
    by padding and summation order."""
    _, _, (_, tcfg), init = _cluster_case("sage")
    runs = [t_cluster(load_dataset("synth-tiny"), tcfg, TTC(**CLUSTER_KW),
                      init_params=init, scan_batches=scan, device="cpu",
                      **CLUSTER_COMMON) for scan in (False, True)]
    _assert_close(runs[1], runs[0], int(load_dataset(
        "synth-tiny").val_mask.sum()), rtol=1e-5)
    assert runs[1]["steady_epoch_s"] > 0


def test_stack_batches_views_equal_batches():
    """Each view of a stacked round is its batch's graph, re-padded to
    the round's bucket, with ``n_edges`` at the padded count."""
    ds = load_dataset("synth-tiny")
    sampler = TSM.ClusterSampler(ds, 6, 2, seed=0, tiles=True)
    batches = TSM.unify_tile_buckets(
        _RoundCollector(sampler, len(sampler), ids_only=True).collect())
    stacked = TSM.stack_batches(batches)
    views = stacked.views()
    assert len(views) == len(batches) == 3
    for (g, ids), b in zip(views, batches):
        assert torch.equal(ids, b.node_ids)
        assert g.n_edges == g.n_edges_padded == b.graph.n_edges_padded
        assert g.dedup.max_jobs == b.graph.dedup.max_jobs
        for name in ("senders", "receivers", "indptr", "in_degrees",
                     "t_senders"):
            assert torch.equal(getattr(g, name), getattr(b.graph, name))
        for name in ("w_blocks", "job_offsets", "u_senders"):
            assert torch.equal(getattr(g.dedup, name),
                               getattr(b.graph.dedup, name))
            assert torch.equal(getattr(g.dedup_t, name),
                               getattr(b.graph.dedup_t, name))
    assert ("n_nodes", batches[0].graph.n_nodes) in stacked.key
    # another round: same key when every shape matches
    again = TSM.stack_batches(batches)
    assert again.key == stacked.key and hash(again.key) == hash(stacked.key)


def test_stack_batches_rejects_mixed_host_values():
    ds = load_dataset("synth-tiny")
    sampler = TSM.ClusterSampler(ds, 6, 2, seed=0)
    a, b = _RoundCollector(sampler, 2, ids_only=True).collect()
    b = b.replace(graph=b.graph.replace(n_nodes=b.graph.n_nodes + 1))
    with pytest.raises(ValueError, match="host value"):
        TSM.stack_batches([a, b])


def _full_case(rng, model):
    n, f, c = 400, 12, 5
    s, r = make_random_graph(rng, n, 2400)
    feats = rng.standard_normal((n, f)).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    split = rng.random(n)
    masks = (split < 0.5, (split >= 0.5) & (split < 0.75), split >= 0.75)
    jds, tds = [cls("rand", s, r, feats.copy(), labels.copy(), *masks, c)
                for cls in (JDataset, Dataset)]
    if model == "gat":
        cfgs = (jgat.GATConfig(f, 16, c, n_layers=2, n_heads=2),
                tgat.GATConfig(f, 16, c, n_layers=2, n_heads=2))
        mods = (jgat, tgat)
    else:
        cfgs = (jgcn.GCNConfig(f, 16, c, n_layers=1, dropout=0.0),
                tgcn.GCNConfig(f, 16, c, n_layers=1, dropout=0.0))
        mods = (jgcn, tgcn)
    init = _np_tree(mods[0].init(jax.random.PRNGKey(0), cfgs[0]))
    return (jds, tds), mods, cfgs, init


@pytest.mark.parametrize("model", ["gcn", "gat"])
@pytest.mark.parametrize("lr_schedule", [False, True])
def test_full_graph_scan_matches_jax(rng, model, lr_schedule):
    """Five epochs in blocks of 2 (the last block short), the LR
    schedule's steps inside blocks."""
    (jds, tds), (jm, tm), (jcfg, tcfg), init = _full_case(rng, model)
    kw = dict(lr=1e-2, weight_decay=5e-4, n_epochs=5,
              lr_schedule=lr_schedule)
    want = j_full(jds, jcfg, JTC(**kw), model=jm, scan_epochs=2,
                  verbose=False)
    got = t_full(tds, tcfg, TTC(**kw), model=tm, scan_epochs=2,
                 init_params=init, device="cpu", verbose=False)
    assert set(want) <= set(got) and got["scan_epochs"] == 2
    _assert_close(got, want, int(tds.val_mask.sum()))
    assert got["mean_epoch_s"] > 0 and got["losses"][-1] < got["losses"][0]


def test_full_graph_scan_on_v1_layout_matches_jax(rng):
    """GAT on the v1 gather layout (K7-K9's plain walks) and GCN on it
    (K3's), scanned, against the JAX scan on the segment path."""
    for model in ("gat", "gcn"):
        (jds, tds), (jm, tm), (jcfg, tcfg), init = _full_case(rng, model)
        kw = dict(lr=1e-2, weight_decay=5e-4, n_epochs=4, lr_schedule=True)
        want = j_full(jds, jcfg, JTC(**kw), model=jm, scan_epochs=2,
                      verbose=False)
        graph = TG.graph_from_edges(tds.senders, tds.receivers, tds.n_nodes,
                                    tiles=True, tile_mode="gather")
        TS.set_default_backend("dedup")
        try:
            got = t_full(tds, tcfg, TTC(**kw), model=tm, scan_epochs=2,
                         init_params=init, graph=graph, device="cpu",
                         verbose=False)
        finally:
            TS.set_default_backend("auto")
        _assert_close(got, want, int(tds.val_mask.sum()))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_full_graph_scan_matches_loop(rng, k):
    """Any block length gives the loop's losses and accuracies; the
    first block is left out of the epoch time."""
    (_, tds), (_, tm), (_, tcfg), init = _full_case(rng, "gcn")
    kw = dict(lr=1e-2, weight_decay=5e-4, n_epochs=6, lr_schedule=True)
    loop = t_full(tds, tcfg, TTC(**kw), model=tm, init_params=init,
                  device="cpu", verbose=False)
    scan = t_full(tds, tcfg, TTC(**kw), model=tm, init_params=init,
                  scan_epochs=k, device="cpu", verbose=False)
    _assert_close(scan, loop, int(tds.val_mask.sum()), rtol=1e-5)
    assert scan["scan_epochs"] == k and "scan_epochs" not in loop
    # 6 epochs in blocks of k >= 6: one block, nothing left to time
    assert (scan["mean_epoch_s"] > 0) == (k < 6)


def test_capturable_adam_matches_plain():
    """``make_optimizer(capturable=True)``: a tensor LR written in place
    each step (here the schedule's /10 steps) gives the plain Adam's
    update, coupled weight decay included, over 5 steps."""
    g = torch.Generator().manual_seed(0)
    start = [torch.randn(7, 3, generator=g), torch.randn(3, generator=g)]
    grads = [[torch.randn(p.shape, generator=g) for p in start]
             for _ in range(5)]
    plain = [p.clone().requires_grad_(True) for p in start]
    tensor_lr = [p.clone().requires_grad_(True) for p in start]
    a = make_optimizer(plain, 1e-2, 5e-4)
    b = make_optimizer(tensor_lr, 1e-2, 5e-4, capturable=True)
    lr = b.param_groups[0]["lr"]
    assert torch.is_tensor(lr) and lr.dim() == 0
    for step, gs in enumerate(grads):
        value = 1e-2 / 10 ** (step // 2)
        for group in a.param_groups:
            group["lr"] = value
        lr.fill_(value)
        for p, q, gr in zip(plain, tensor_lr, gs):
            p.grad, q.grad = gr.clone(), gr.clone()
        a.step()
        b.step()
    for p, q in zip(plain, tensor_lr):
        torch.testing.assert_close(q, p, rtol=1e-6, atol=1e-7)
    assert not torch.equal(plain[0], start[0])


def test_scan_paths_need_a_card_or_the_cpu():
    """Without a card the default device raises; the CPU runs only when
    asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    ds = load_dataset("synth-tiny")
    cfg = tsage.SAGEConfig(ds.in_feats, 8, ds.n_classes, dropout=0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cluster(ds, cfg, TTC(n_epochs=1), psize=4, batch_size=2,
                  scan_batches=True, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_full(ds, tgcn.GCNConfig(ds.in_feats, 8, ds.n_classes),
               TTC(n_epochs=1), scan_epochs=2, verbose=False)
