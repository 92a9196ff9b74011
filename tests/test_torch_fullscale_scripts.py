"""The port's full-scale benchmark scripts (``gist_tpu_torch/bench/``:
``amazon_spmm``, ``gat_chunked``, ``uw_k1_probe``, ``ist_sharded_2d``,
``amazon_uw_fullscale``, ``cluster_fullscale``) on the CPU at synth-tiny
sizes, each held against the JAX script's computation on the same
inputs (the Pallas kernels in interpret mode), and K1's plain walk at
CU 512.  Tolerances: layouts array-equal; aggregations 1e-5 relative to
the max (fp32 sums in another order); trainers' losses 1e-4 relative
and params 1e-4 (Adam amplifies last-bit differences); a resumed run
equal to the straight one exactly (the same CPU arithmetic)."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gist_tpu.graph as JG
from gist_tpu.data import synthetic_dataset as jax_synth
from gist_tpu.ist import ultrawide as JU
from gist_tpu.ist.partition import boundary_sizes as j_sizes
from gist_tpu.models import common as jcommon
from gist_tpu.models import gat as jgat
from gist_tpu.models import sage as jsage
from gist_tpu.ops import pallas_spmm
from gist_tpu.sampler import ClusterSampler as JSampler
from gist_tpu.train.common import TrainConfig as JTC
from gist_tpu.train.ist_cluster import _RoundCollector as JCollector
from gist_tpu.train.ist_cluster import _stack_batches
from gist_tpu.train.ist_ultrawide import train_ist_ultrawide as j_uw

import gist_tpu_torch.graph as TG
from gist_tpu_torch.bench import (amazon_spmm, amazon_uw_fullscale, common,
                                  cluster_fullscale, gat_chunked,
                                  ist_sharded_2d, uw_k1_probe)
from gist_tpu_torch.cli import cluster_gcn
from gist_tpu_torch.data import load_dataset
from gist_tpu_torch.ops import dedup_spmm as K
from gist_tpu_torch.ops.spmm import spmm_segment
from torch_dist_workers import run_world
from torch_port_helpers import load_jax_partitioner, run_interpret

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = "synth-tiny"
LAYOUT_FIELDS = ("u_senders", "w_blocks", "job_offsets", "pos", "perm",
                 "dir_blk", "rem_blk", "is_dir")


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _graph(seed=0, n=2000, e=40000):
    """A random graph with hubs of repeated (tile, block) pairs, so a
    small split threshold gives direct jobs."""
    rng = np.random.default_rng(seed)
    s = np.concatenate([rng.integers(0, n, e // 2),
                        rng.integers(0, 64, e // 2)])
    r = np.concatenate([rng.integers(0, n, e // 2),
                        rng.integers(0, 128, e // 2)])
    return s, r, n


def _np(t):
    return None if t is None else np.asarray(t)


# --- amazon_spmm: the v2 / v3 layouts, K1 and K2 once per chunk ----------


@pytest.mark.parametrize("cu", [512, 1024])
@pytest.mark.parametrize("threshold", [0, 4])
def test_amazon_spmm_layouts_equal_jax(threshold, cu):
    """``build_layout`` (TN 64) array-equal to the JAX script's
    ``_build_dedup_chunked`` (threshold 0) or
    ``_build_dedup_split_chunked``, and the script's layout keys
    (``n_chunks``, ``gathered_rows``, ``direct_jobs``) as JAX counts
    them."""
    s, r, n = _graph()
    ds = type("DS", (), dict(senders=s, receivers=r, n_nodes=n))
    dt = amazon_spmm.build_layout(ds, threshold=threshold, cu=cu,
                                  chunk_rows=2 ** 10)
    if threshold == 0:
        dj = JG._build_dedup_chunked(s, r, n, tile_rows=64, cu=cu,
                                     chunk_rows=2 ** 10)
    else:
        dj = JG._build_dedup_split_chunked(s, r, n, tile_rows=64, cu=cu,
                                           threshold=threshold,
                                           chunk_rows=2 ** 10)
    assert (dt.tile_rows, dt.cu) == (64, cu)
    for k in LAYOUT_FIELDS:
        a, b = _np(getattr(dj, k)), getattr(dt, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, b.numpy(), err_msg=k)
    # the split layout's chunks hold its remote rows: one chunk here
    assert dt.n_chunks == dj.n_chunks and (threshold or dt.n_chunks > 1)
    assert int(dt.u_senders.numel()) == int(np.asarray(dj.u_senders).size)
    if threshold:
        assert int(dt.is_dir.sum()) == int(np.asarray(dj.is_dir).sum()) > 0


@pytest.mark.parametrize("cu", [512, 1024])
@pytest.mark.parametrize("threshold", [0, 4])
def test_amazon_spmm_run_matches_jax_segment(threshold, cu):
    """The script's measurement on the CPU: the chunked pass (K1's or
    K2's plain walk here) equals the whole segment output within 1e-5,
    and the JAX script's reference, ``spmm_segment_chunked``, gives the
    same sum (1e-5)."""
    ds = load_dataset(TINY)
    dc = amazon_spmm.build_layout(ds, threshold=threshold, cu=cu,
                                  chunk_rows=2 ** 11)
    rec = amazon_spmm.run(ds, dc, "cpu", iters=1, segment_iters=1,
                          plain=True)
    assert rec["kernel"] == ("K2" if threshold else "K1")
    assert rec["plain_rel_err"] == 0.0 and rec["finite"]
    assert rec["rel_err_vs_segment"] <= 1e-5
    assert rec["hardware"] == "cpu" and rec["power_limit_w"] is None
    assert rec["bound_by"] in ("bytes", "operations")
    from gist_tpu.ops.spmm import spmm_segment_chunked as j_seg
    jg = JG.graph_from_edges(ds.senders, ds.receivers, ds.n_nodes)
    want = np.asarray(j_seg(jg, jnp.asarray(ds.features)))
    got = K.run_dedup_chunked(dc, torch.from_numpy(ds.features),
                              ds.n_nodes).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


@pytest.mark.parametrize("chunked", [False, True])
def test_k1_plain_walk_at_cu512(chunked):
    """K1's plain walk on layouts of 512 slots a job equals the segment
    sum within 1e-5 (flat and chunked, TN 64), and on the flat layout
    the JAX ``_dedup_kernel`` in interpret mode on the array-equal
    layout."""
    s, r, n = _graph(1, 1500, 30000)
    x = np.random.default_rng(2).standard_normal((n, 24)).astype(np.float32)
    g = TG.graph_from_edges(s, r, n)
    want = spmm_segment(g, torch.from_numpy(x)).numpy()
    if chunked:
        t = TG._build_dedup_chunked(s, r, n, tile_rows=64, cu=512,
                                    chunk_rows=2 ** 11)
        assert t.n_chunks > 1 and t.w_blocks.shape[-1] == 512
        got = K.run_dedup_chunked(t, torch.from_numpy(x), n).numpy()
    else:
        t = TG._build_dedup_tiles(s, r, n, tile_rows=64, cu=512,
                                  reorder=False)
        assert t.w_blocks.shape[1:] == (64, 512)
        got = K.run_dedup(t, torch.from_numpy(x), n).numpy()
        dj = JG._build_dedup_tiles(s, r, n, tile_rows=64, cu=512,
                                   reorder=False)
        np.testing.assert_array_equal(np.asarray(dj.w_blocks),
                                      t.w_blocks.numpy())
        gj = JG.graph_from_edges(s, r, n).replace(dedup=dj)
        pal = run_interpret(lambda: pallas_spmm.spmm_pallas_csr(
            gj, jnp.asarray(x)))
        assert np.abs(got - pal).max() / np.abs(pal).max() <= 1e-5
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


def test_layout_caches_name_every_parameter(tmp_path):
    """A cache file's name carries TN, CU, chunk rows, threshold (or the
    chunk rows of the GAT layout) and the graph's hash, never a JAX
    cache's name; a cached layout reads back equal."""
    ds = load_dataset(TINY)
    names = {amazon_spmm.cache_path(ds, str(tmp_path), threshold=t, cu=cu,
                                    chunk_rows=c)
             for t in (0, 128) for cu in (512, 1024) for c in (2 ** 11,
                                                               2 ** 21)}
    assert len(names) == 8
    for name in names:
        base = pathlib.Path(name).name
        assert base.startswith("torch_amazon_spmm_synth-tiny_tn64_")
        assert common.graph_digest(ds.senders, ds.receivers,
                                   ds.n_nodes) in base
    assert amazon_spmm.cache_path(ds, "", threshold=0, cu=1024,
                                  chunk_rows=2 ** 11) is None
    path = amazon_spmm.cache_path(ds, str(tmp_path), threshold=4, cu=512,
                                  chunk_rows=2 ** 11)
    built = common.cached_chunked(path, lambda: amazon_spmm.build_layout(
        ds, threshold=4, cu=512, chunk_rows=2 ** 11))
    back = common.cached_chunked(path, lambda: None)
    for k in LAYOUT_FIELDS:
        a, b = getattr(built, k), getattr(back, k)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), k
    g1 = gat_chunked.cache_path(ds, str(tmp_path), 2 ** 11)
    assert g1 != gat_chunked.cache_path(ds, str(tmp_path), 2 ** 12)
    for name in names | {g1}:
        base = pathlib.Path(name).name
        assert not base.startswith(("amazon_spmm_layout_", "gatc_layout_"))


# --- gat_chunked: K4 once per chunk and the zero-score check -------------


def test_gat_chunked_matches_jax():
    """The forward-only chunked layout array-equal to JAX's; the
    zero-score attention equals K1 once per chunk times 1/in_deg within
    1e-5; the untrained 2-layer eval's val micro-F1 equals the JAX
    ``gat.apply`` (interpret mode) on the same params."""
    ds = load_dataset(TINY)
    graph, _ = gat_chunked.build_graph(ds, 2 ** 11)
    jg = JG.graph_from_edges(ds.senders, ds.receivers, ds.n_nodes).\
        with_tiles(mode="dedup-chunked", chunk_rows=2 ** 11, transpose=False)
    for k in LAYOUT_FIELDS:
        a, b = _np(getattr(jg.dedup_c, k)), getattr(graph.dedup_c, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, b.numpy(), err_msg=k)
    rec = gat_chunked.run(ds, graph, "cpu", hidden=8, heads=2, iters=1)
    assert rec["zero_score_rel_err_vs_spmm"] <= gat_chunked.ZERO_SCORE_TOL
    assert rec["logits_finite"] and rec["layout"]["n_chunks"] >= 1
    from gist_tpu_torch.models import gat as tgat
    from gist_tpu_torch.train.common import seeded_init
    cfg = tgat.GATConfig(ds.in_feats, 8, ds.n_classes, n_layers=2,
                         n_heads=2)
    params = seeded_init(tgat, cfg, 0, "cpu")
    jp = {"layers": [{k: jnp.asarray(v.numpy()) for k, v in l.items()}
                     for l in params["layers"]]}
    jcfg = jgat.GATConfig(ds.in_feats, 8, ds.n_classes, n_layers=2,
                          n_heads=2)
    logits = run_interpret(lambda: jgat.apply(
        jp, jg, jnp.asarray(ds.features), jcfg, backend="pallas"))
    assert rec["untrained_val_f1"] == jcommon.micro_f1(logits, ds.labels,
                                                       ds.val_mask)


# --- uw_k1_probe: the K=1 burst and its projection ------------------------


def _jax_probe(ds, init, hidden, steps, rounds, psize, batch):
    """The JAX probe's round loop (its ``UW_BACKEND=tpu`` branch):
    (per-round mean losses, final full params)."""
    cfg = jsage.SAGEConfig(ds.in_feats, hidden, ds.n_classes, n_layers=4,
                           dropout=0.0)
    sampler = JSampler(ds, psize, batch, seed=0)
    tables = sampler.tables()
    collector = JCollector(sampler, steps, ids_only=True)
    sub_cfg = cfg.sub_config(split_input=False, split_output=True,
                             num_subnet=1)
    sizes = j_sizes(cfg.in_feats, cfg.n_hidden, cfg.n_layers,
                    split_input=False, split_output=True)
    burst = JU.build_local_burst_single(jsage, sub_cfg, weight_decay=0.0)
    rng = np.random.default_rng(1)
    full = jax.tree.map(lambda a: np.array(a, copy=True), init)
    losses = []
    for _ in range(rounds):
        bnds = JU.sample_boundaries_host(rng, sizes, 1)
        batches = _stack_batches(collector.collect())
        sub = jax.tree.map(lambda a: jnp.asarray(a[0]),
                           JU.dispatch_host(full, bnds, 1, "sage"))
        sub, rl = burst(sub, batches, jnp.asarray(1e-2),
                        jax.random.PRNGKey(0), jnp.asarray(0), tables)
        losses.append(float(np.mean(np.asarray(rl))))
        full = JU.merge_host(full, bnds, jax.tree.map(
            lambda a: np.asarray(a)[None], sub), 1, "sage")
    return losses, full


def test_uw_k1_probe_matches_jax():
    """The probe's rounds on synth-tiny (h16, dropout 0, the JAX init)
    against the JAX probe's loop: per-round losses 1e-4 relative, the
    merged full-width params 1e-4."""
    dsj = jax_synth(TINY)
    dsj.normalize_features()
    ds = load_dataset(TINY)
    ds.normalize_features()
    jcfg = jsage.SAGEConfig(ds.in_feats, 16, ds.n_classes, n_layers=4,
                            dropout=0.0)
    init = jax.tree.map(np.asarray, jsage.init(jax.random.PRNGKey(0), jcfg))
    want_losses, want = _jax_probe(dsj, init, 16, 2, 3, 8, 2)
    rec = uw_k1_probe.run(ds, "cpu", hidden=16, steps=2, rounds=3, psize=8,
                          batch_size=2, dropout=0.0, init_params=init)
    np.testing.assert_allclose(rec["losses"], want_losses, rtol=1e-4)
    for lj, lt in zip(want["layers"], rec["params"]["layers"]):
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], rtol=1e-4, atol=1e-4)
    assert len(rec["bucket_shapes"]) == 3 and rec["steps_per_epoch"] == 4


def test_uw_k1_probe_projection():
    """``round750_s = fixed_s + 750 * s_per_step``: ``s_per_step`` the
    least steady burst (the first round left out) over the burst's
    steps, ``fixed_s`` the median fixed wall; K=1 runs ``budget *
    steps_per_epoch // 750`` rounds, at least one."""
    p = uw_k1_probe.projection([3.0, 1.0, 2.0], [100.0, 6.0, 5.0], 50,
                               1500, 40)
    assert p["s_per_step_full_width"] == 0.1
    assert p["fixed_s_per_round"] == 2.0
    assert p["projected_round750_s"] == pytest.approx(77.0)
    assert p["n_rounds_at_budget"] == 80
    assert p["projected_train_s_at_budget"] == pytest.approx(6160.0)
    assert uw_k1_probe.projection([1.0], [9.0, 1.0], 10, 4, 1)[
        "n_rounds_at_budget"] == 1


def test_uw_k1_probe_budget_from_the_comparator(tmp_path, capsys):
    """``main`` takes the epoch budget from the port's K=8 comparator
    record (``config.n_epochs``), 40 without one, and prints one line."""
    cmp = tmp_path / "cmp.json"
    args = ["--dataset", TINY, "--hidden", "8", "--steps", "2", "--psize",
            "8", "--batch-size", "2", "--cache-dir", "", "--device", "cpu",
            "--comparator", str(cmp), "--out", str(tmp_path / "o.json")]
    assert uw_k1_probe.main(args) == 0
    rec = json.loads((tmp_path / "o.json").read_text())
    assert rec["budget_epochs"] == 40 and rec["comparator"] is None
    cmp.write_text(json.dumps({"config": {"n_epochs": 24}}))
    assert uw_k1_probe.main(args) == 0
    rec = json.loads((tmp_path / "o.json").read_text())
    assert rec["budget_epochs"] == 24 and rec["comparator"] == str(cmp)
    assert rec["comparator_budget_epochs"] == 24
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines[-1] == rec and "params" not in rec
    assert uw_k1_probe.comparator_path(2048) == \
        "results/torch_amazon_uw_fullscale_h2048_k8.json"


# --- ist_sharded_2d: the 2-D run and its 1-D control ----------------------


S2, G2, ROUNDS2, STEPS2, H2 = 2, 2, 2, 2, 16


def _jax_2d(ds, init, bnds_per_round):
    """The JAX script's loop at S=2 x G=2: (2-D params, 1-D params, the
    2-D run's round losses, both val curves)."""
    from gist_tpu.ist.distributed import build_ist_round, make_subnet_mesh
    from gist_tpu.parallel import build_sharded_graph
    from gist_tpu.parallel.graph_shard import shard_features
    from gist_tpu.parallel.ist_sharded import (build_ist_sharded_round,
                                               make_ist_graph_mesh)
    cfg = jsage.SAGEConfig(ds.in_feats, H2, ds.n_classes, n_layers=2,
                           dropout=0.0)
    g_flat = JG.graph_from_edges(ds.senders, ds.receivers, ds.n_nodes)
    x_flat = jnp.asarray(ds.features)
    mesh2 = make_ist_graph_mesh(S2, G2)
    sg = build_sharded_graph(ds.senders, ds.receivers, ds.n_nodes, G2)
    xs = shard_features(sg, ds.features, mesh2)
    perm = np.asarray(sg.node_perm)
    lab = np.zeros(sg.total_rows, np.int32)
    lab[perm] = ds.labels
    msk = np.zeros(sg.total_rows, bool)
    msk[perm] = ds.train_mask
    round2d = build_ist_sharded_round(sg, mesh2, num_subnet=S2,
                                      weight_decay=0.0, n_steps=STEPS2)
    sub_cfg = cfg.sub_config(split_input=False, split_output=True,
                             num_subnet=S2)
    round1d = build_ist_round(jsage, sub_cfg, mesh=make_subnet_mesh(S2),
                              kind="sage", num_subnet=S2, weight_decay=0.0,
                              split_input=False)
    batches1 = (
        jax.tree.map(lambda a: jnp.broadcast_to(a, (STEPS2,) + a.shape),
                     g_flat),
        jnp.broadcast_to(x_flat, (STEPS2,) + x_flat.shape),
        jnp.broadcast_to(jnp.asarray(ds.labels), (STEPS2,) + ds.labels.shape),
        jnp.broadcast_to(jnp.asarray(ds.train_mask),
                         (STEPS2,) + ds.train_mask.shape))
    p2, p1 = (jax.tree.map(jnp.asarray, init),) * 2
    losses, vals = [], {"2d": [], "1d": []}
    key = jax.random.PRNGKey(11)
    for b in bnds_per_round:
        bnds = [None if x is None else jnp.asarray(x) for x in b]
        p2, l2 = round2d(p2, bnds, xs, jnp.asarray(lab), jnp.asarray(msk),
                         jnp.asarray(1e-2), key)
        p1, _ = round1d(p1, bnds, batches1, jnp.asarray(1e-2), key, None)
        losses.append(float(np.mean(np.asarray(l2)[0])))
        for tag, p in (("2d", p2), ("1d", p1)):
            pred = np.asarray(jsage.apply(p, g_flat, x_flat, cfg)).argmax(-1)
            vals[tag].append(float(
                (pred[ds.val_mask] == ds.labels[ds.val_mask]).mean()))
    return (jax.tree.map(np.asarray, p2), jax.tree.map(np.asarray, p1),
            losses, vals)


def test_ist_sharded_2d_matches_jax():
    """The script's run in a gloo world of 2 x 2 CPU ranks, from the JAX
    init and boundaries, against the JAX script's 2-D round and 1-D
    control on the 8-device CPU mesh: both runs' params 1e-4, the 2-D
    round losses 1e-5 relative, both val curves equal; every rank
    returns the same record, and the 2-D run equals its 1-D control."""
    from gist_tpu.ist.partition import sample_boundaries
    ds = jax_synth(TINY)
    cfg = jsage.SAGEConfig(ds.in_feats, H2, ds.n_classes, n_layers=2,
                           dropout=0.0)
    init = jax.tree.map(np.asarray, jsage.init(jax.random.PRNGKey(0), cfg))
    sizes = j_sizes(cfg.in_feats, cfg.n_hidden, cfg.n_layers,
                    split_input=False, split_output=True)
    bnds = [[None if b is None else np.asarray(b) for b in
             sample_boundaries(jax.random.PRNGKey(40 + i), sizes, S2)]
            for i in range(ROUNDS2)]
    out = run_world(S2 * G2, [("run", dict(fn="ist_2d_script"))],
                    {"init": init, "bnds": bnds,
                     "cfg": dict(subnets=S2, graph=G2, rounds=ROUNDS2,
                                 steps=STEPS2, hidden=H2)},
                    timeout_s=120)["run"]
    p2, p1, losses, vals = _jax_2d(ds, init, bnds)
    rec = out[0]
    for want, got in ((p2, rec["params_2d"]), (p1, rec["params_1d"])):
        for lj, lt in zip(want["layers"], got["layers"]):
            for k in lj:
                np.testing.assert_allclose(lt[k], lj[k], rtol=1e-4,
                                           atol=1e-4)
    np.testing.assert_allclose(rec["curves"]["2d"]["loss"], losses,
                               rtol=1e-5)
    assert rec["curves"]["2d"]["val"] == vals["2d"]
    assert rec["curves"]["1d"]["val"] == vals["1d"]
    assert rec["max_val_gap_2d_vs_1d"] == 0.0
    assert rec["backend"] == "gloo" and rec["world"] == 4
    assert rec["mesh"] == [S2, G2]
    for other in out[1:]:
        for tag in ("2d", "1d"):
            for key in ("loss", "val", "test"):
                assert other["curves"][tag][key] == rec["curves"][tag][key]


# --- amazon_uw_fullscale: resume by key -----------------------------------


UW = dict(hidden=16, k=2, eval_every=1, psize=8, batch_size=2,
          iter_per_site=2)


def _uw_ds():
    ds = load_dataset(TINY)
    ds.normalize_features()
    return ds


def test_amazon_uw_fullscale_resume_by_key(tmp_path):
    """One round, then a rerun with the same key to two, equals two
    rounds straight, exactly: the rerun resumes after round 0 and trains
    round 1 only, round 0's record stays as the first call wrote it, and
    the checkpointed params are equal."""
    from gist_tpu_torch.train.checkpoint import load_checkpoint
    ck, straight = tmp_path / "ck", tmp_path / "straight"
    # local epochs = epochs // K; rounds = local epochs * 4 batches // 2
    first = amazon_uw_fullscale.run(_uw_ds(), "cpu", epochs=2,
                                    ckpt=str(ck), verbose=False, **UW)
    assert first["n_rounds"] == 2 and first["resumed_from_round"] == 0
    # a one-round first call: cut the first call's run at round 0
    ck1 = tmp_path / "ck1"
    one = amazon_uw_fullscale.run(_uw_ds(), "cpu", epochs=2,
                                  ckpt=str(ck1), verbose=False,
                                  **{**UW, "iter_per_site": 4})
    assert one["n_rounds"] == 1
    resumed_a = amazon_uw_fullscale.run(_uw_ds(), "cpu", epochs=4,
                                        ckpt=str(ck1), verbose=False,
                                        **{**UW, "iter_per_site": 4})
    whole = amazon_uw_fullscale.run(_uw_ds(), "cpu", epochs=4,
                                    ckpt=str(straight), verbose=False,
                                    **{**UW, "iter_per_site": 4})
    assert resumed_a["resumed_from_round"] == 1
    assert resumed_a["rounds_this_call"] == 1 and whole["n_rounds"] == 2
    assert resumed_a["losses"][0] == one["losses"][0]
    assert resumed_a["val_accs"][0] == one["val_accs"][0]
    for key in ("losses", "val_accs", "test_accs", "eval_rounds"):
        assert resumed_a[key] == whole[key], key
    a = load_checkpoint(str(ck1 / "round_1"))["params"]
    b = load_checkpoint(str(straight / "round_1"))["params"]
    for la, lb in zip(a["layers"], b["layers"]):
        for k in la:
            assert np.array_equal(np.asarray(la[k]), np.asarray(lb[k]))
    # a rerun of a finished run trains nothing and keeps the curve
    again = amazon_uw_fullscale.run(_uw_ds(), "cpu", epochs=4,
                                    ckpt=str(straight), verbose=False,
                                    **{**UW, "iter_per_site": 4})
    assert again["rounds_this_call"] == 0
    assert again["losses"] == whole["losses"]


def test_amazon_uw_fullscale_keeps_a_cut_calls_rounds(tmp_path):
    """A call cut after its first eval (its later checkpoint never
    written) leaves round 0's record in round 0's checkpoint: the next
    call trains round 1 only, and its curve starts with round 0 as the
    cut call recorded it and equals a straight run's."""
    import shutil
    ck = tmp_path / "ck"
    whole = amazon_uw_fullscale.run(_uw_ds(), "cpu", epochs=2,
                                    ckpt=str(ck), verbose=False, **UW)
    assert whole["n_rounds"] == 2
    shutil.rmtree(ck / "round_1")       # as if the call was cut there
    again = amazon_uw_fullscale.run(_uw_ds(), "cpu", epochs=2,
                                    ckpt=str(ck), verbose=False, **UW)
    assert again["resumed_from_round"] == 1
    assert again["rounds_this_call"] == 1
    assert again["round_wall_s"][0] == whole["round_wall_s"][0]
    for key in ("losses", "val_accs", "test_accs", "eval_rounds"):
        assert again[key] == whole[key], key


def test_amazon_uw_fullscale_matches_jax():
    """The script's run (dropout 0, the JAX init) against the JAX
    trainer it drives, ``train_ist_ultrawide(sequential=True)``: round
    losses 1e-4 relative, the last val F1 equal."""
    dsj = jax_synth(TINY)
    cfg = jsage.SAGEConfig(dsj.in_feats, 16, dsj.n_classes, n_layers=4,
                           dropout=0.0)
    init = jax.tree.map(np.asarray, jsage.init(jax.random.PRNGKey(0), cfg))
    tc = JTC(lr=1e-2, weight_decay=0.0, n_epochs=4, num_subnet=2,
             iter_per_site=2)
    rj = j_uw(dsj, cfg, tc, psize=8, batch_size=2, use_f1=True,
              normalize=True, sequential=True, verbose=False)
    rec = amazon_uw_fullscale.run(_uw_ds(), "cpu", epochs=4, dropout=0.0,
                                  init_params=init, verbose=False, **UW)
    assert len(rec["losses"]) == len(rj["losses"]) == 4
    np.testing.assert_allclose(rec["losses"], rj["losses"], rtol=1e-4)
    assert rec["val_accs"][-1] == rj["val_accs"][-1]


# --- cluster_fullscale: the shell script's CLI call -----------------------


def test_cluster_fullscale_is_the_cli_with_the_scripts_flags(tmp_path):
    """``cli_argv`` carries every flag of
    ``benchmarks/amazon_cluster_fullscale.sh`` (its output path and the
    port's ``--device`` aside), and ``run`` equals ``cli.cluster_gcn``
    with those flags."""
    sh = (ROOT / "benchmarks" / "amazon_cluster_fullscale.sh").read_text()
    jax_flags = {t for t in sh.split() if t.startswith("--")}
    argv = cluster_fullscale.cli_argv()
    assert {t for t in argv if t.startswith("--")} == \
        jax_flags - {"--result-json"} | {"--device"}
    kw = dict(dataset=TINY, n_epochs=2, eval_every=1, psize=8, batch_size=2,
              cache_dir=str(tmp_path), device="cpu", n_hidden=32)
    rec = cluster_fullscale.run(**kw)
    want = cluster_gcn.main(cluster_fullscale.cli_argv(**kw))
    assert rec["losses"] == want["losses"]
    assert rec["val_accs"] == want["val_accs"]
    assert rec["hardware"] == "cpu" and rec["kernel_launches"] == {}


# --- default outputs -------------------------------------------------------


def test_default_outputs_never_name_an_existing_result():
    """Every new script writes ``results/torch_<name>.json`` by default,
    never a file of the JAX package's records."""
    existing = {p.name for p in (ROOT / "results").iterdir()}
    outs = [amazon_spmm.default_out(t, cu) for t in (0, 128)
            for cu in (512, 1024)]
    outs += [gat_chunked.DEFAULT_OUT, ist_sharded_2d.DEFAULT_OUT,
             cluster_fullscale.DEFAULT_OUT,
             uw_k1_probe.comparator_path(1024),
             common.results_path("uw_k1_probe_h2048"),
             amazon_uw_fullscale.default_out(512, 8),
             amazon_uw_fullscale.default_out(2048, 1, "r5")]
    assert len(set(outs)) == len(outs)
    for path in outs:
        p = pathlib.PurePath(path)
        assert p.parent.name == "results" and p.name.startswith("torch_")
        assert p.name not in existing, path
    assert amazon_uw_fullscale.default_ckpt(512, 8) == \
        "data/torch_uw_ckpt_h512_k8"
