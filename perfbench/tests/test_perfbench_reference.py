"""The plain reference against the port at a tiny size on the CPU: the
generator, the batch stream and induced edges, the boundary draws, the
slicing and the merge, both models' forward passes and Adam."""

import numpy as np
import pytest
import torch

from perfbench.reference import batches, graphgen, models, streams, weights


@pytest.fixture(scope="module")
def tiny():
    from gist_tpu_torch.data.synthetic import synthetic_dataset
    return synthetic_dataset("synth-tiny")


@pytest.fixture(scope="module")
def sampler(tiny, tmp_path_factory):
    from gist_tpu_torch.sampler import ClusterSampler
    return ClusterSampler(tiny, 8, 2, seed=2 ** 31 + 5, tiles=False,
                          cache_dir=str(tmp_path_factory.mktemp("part")))


def test_generator_is_the_programs(tiny):
    a = graphgen.generate("synth-tiny")
    for k in ("senders", "receivers", "features", "labels", "train_mask",
              "val_mask", "test_mask"):
        np.testing.assert_array_equal(a[k], getattr(tiny, k))


def test_batch_stream_and_edges_are_the_samplers(tiny, sampler):
    stream = batches.BatchStream(sampler.partitions, 2, 2 ** 31 + 5)
    ids = sampler.iter_node_ids()
    arrays = {k: getattr(tiny, k) for k in ("senders", "receivers",
                                            "train_mask")}
    tg = batches.TrainGraph(arrays, "cpu")
    assert batches.check_partition(sampler.partitions, tg.n_train) == 0
    for j in range(3 * len(sampler)):
        got = next(ids)
        np.testing.assert_array_equal(stream.node_ids(j), got)
        s, r = sampler.csr_subgraph(got)
        rs, rd = tg.induced(got)
        assert batches.same_edges(torch.from_numpy(s), torch.from_numpy(r),
                                  rs, rd, len(got))
    assert not batches.same_edges(torch.from_numpy(s[1:]),
                                  torch.from_numpy(r[1:]), rs, rd, len(got))


def test_bucket_size_is_the_samplers():
    from gist_tpu_torch.sampler import bucket_size
    for n in (1, 255, 256, 257, 1000, 1321, 20011, 146000):
        assert batches.bucket_size(n) == bucket_size(n)


def test_boundary_draws_are_the_programs():
    from gist_tpu_torch.ist.partition import sample_boundaries
    from gist_tpu_torch.ist.ultrawide import sample_boundaries_host
    sizes = [None, 10, 10, None]
    for k in (1, 2, 3):
        a = models.boundaries_host(np.random.default_rng(9), sizes, k)
        b = sample_boundaries_host(np.random.default_rng(9), sizes, k)
        for x, y in zip(a, b):
            assert (x is None and y is None) or np.array_equal(x, y)
        a = models.boundaries_torch(torch.Generator().manual_seed(9),
                                    sizes, k)
        b = sample_boundaries(torch.Generator().manual_seed(9), sizes, k)
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)


def test_round_seeds_are_the_programs():
    from gist_tpu_torch.utils import draw_seed, fold_in
    g = torch.Generator().manual_seed(streams.stream(77, streams.DROPOUT))
    assert streams.round_seeds(77, 3, "cpu") == [draw_seed(g)
                                                 for _ in range(3)]
    assert streams.fold_in(2 ** 61 + 3, 5) == fold_in(2 ** 61 + 3, 5)


def _sage_full():
    g = torch.Generator().manual_seed(3)
    return weights.sage_params(g, 6, 8, 3, 2)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_sage_dispatch_and_merge_are_the_programs(k):
    from gist_tpu_torch.ist.ultrawide import dispatch_host, merge_host
    full = _sage_full()
    np_full = {"layers": [{key: v.numpy().copy() for key, v in l.items()}
                          for l in full["layers"]]}
    sizes = models.boundary_sizes("sage", 6, 8, 2)
    bnds = models.boundaries_host(np.random.default_rng(4), sizes, k)
    prog = dispatch_host(np_full, bnds, k, "sage")
    for s in range(k):
        ref = models.dispatch("sage", full, bnds, s)
        for lp, lr in zip(prog["layers"], ref["layers"]):
            for key in lr:
                np.testing.assert_array_equal(lp[key][s], lr[key].numpy())
    trained = {"layers": [{key: v + 1.0 for key, v in l.items()}
                          for l in prog["layers"]]}
    ref = models.merge("sage", full, bnds, {"layers": [
        {key: torch.from_numpy(v) for key, v in l.items()}
        for l in trained["layers"]]})
    merge_host(np_full, bnds, trained, k, "sage")
    for lp, lr in zip(np_full["layers"], ref["layers"]):
        for key in lr:
            np.testing.assert_array_equal(lp[key], lr[key].numpy())


def test_gat_dispatch_and_merge_are_the_programs():
    from gist_tpu_torch.ist.slicing import dispatch, merge, stack
    g = torch.Generator().manual_seed(5)
    full = weights.gat_params(g, 6, 8, 3, 2, 2)
    sizes = models.boundary_sizes("gat", 6, 8, 2)
    bnds = models.boundaries_torch(torch.Generator().manual_seed(2), sizes,
                                   2)
    subs = []
    for s in range(2):
        prog, ref = dispatch(full, bnds, s, "gat"), models.dispatch(
            "gat", full, bnds, s)
        for lp, lr in zip(prog["layers"], ref["layers"]):
            for key in lr:
                assert torch.equal(lp[key], lr[key])
        subs.append({"layers": [{key: v * 2 for key, v in l.items()}
                                for l in prog["layers"]]})
    st = stack(subs)
    a, b = merge(full, bnds, st, 2, "gat"), models.merge("gat", full, bnds,
                                                         st)
    for lp, lr in zip(a["layers"], b["layers"]):
        for key in lr:
            assert torch.equal(lp[key], lr[key])


def _batch(sampler, tiny):
    ids = next(sampler.iter_node_ids())
    s, r = sampler.csr_subgraph(ids)
    b = sampler.make_batch(ids, edges=(s, r), ids_only=False)
    return b, torch.from_numpy(s), torch.from_numpy(r), len(ids)


def test_sage_forward_is_the_programs(sampler, tiny):
    from gist_tpu_torch.models import sage
    b, s, r, n = _batch(sampler, tiny)
    cfg = sage.SAGEConfig(32, 8, 4, n_layers=2, dropout=0.2)
    params = weights.sage_params(torch.Generator().manual_seed(1), 32, 8, 4,
                                 2)
    prog = sage.apply(params, b.graph, b.features, cfg, train=True,
                      generator=torch.Generator().manual_seed(11))
    ref = models.sage_forward(params["layers"], b.features, s, r, 0.2,
                              torch.Generator().manual_seed(11))
    torch.testing.assert_close(prog, ref, rtol=1e-5, atol=1e-5)


def test_gat_forward_is_the_programs(sampler, tiny):
    from gist_tpu_torch.models import gat
    b, s, r, n = _batch(sampler, tiny)
    cfg = gat.GATConfig(32, 8, 4, n_layers=2, n_heads=2)
    params = weights.gat_params(torch.Generator().manual_seed(1), 32, 8, 4,
                                2, 2)
    prog = gat.apply(params, b.graph, b.features, cfg, backend="segment")
    ref = models.gat_forward(params["layers"], b.features, s, r)
    torch.testing.assert_close(prog, ref, rtol=1e-5, atol=1e-5)


def test_adam_is_the_programs():
    from gist_tpu_torch.train.common import make_optimizer
    g = torch.Generator().manual_seed(0)
    w0 = torch.randn(5, 3, generator=g)
    xs = [torch.randn(7, 5, generator=g) for _ in range(3)]

    def loss_fn(p, x):
        return (x @ p[0]).square().mean()

    losses, g1, p3 = models.adam_steps([w0], loss_fn, xs, 0.01, 5e-4)
    w = w0.clone().requires_grad_(True)
    opt = make_optimizer([w], 0.01, 5e-4)
    for i, x in enumerate(xs):
        opt.zero_grad()
        loss = loss_fn([w], x)
        assert float(loss.detach()) == pytest.approx(losses[i], rel=1e-6)
        loss.backward()
        opt.step()
        if i == 0:
            torch.testing.assert_close(opt.state[w]["exp_avg"] / 0.1, g1[0])
    torch.testing.assert_close(w.detach(), p3[0], rtol=1e-6, atol=1e-7)


def test_initial_weights_have_the_programs_shapes():
    from gist_tpu_torch.models import gat, sage
    s = weights.sage_params(torch.Generator().manual_seed(0), 6, 8, 3, 2)
    p = sage.init(torch.Generator().manual_seed(0),
                  sage.SAGEConfig(6, 8, 3, n_layers=2))
    assert [{k: v.shape for k, v in l.items()} for l in s["layers"]] == \
        [{k: v.shape for k, v in l.items()} for l in p["layers"]]
    bound = [1 / np.sqrt(2 * d) for d in (6, 8, 8)]
    for layer, b in zip(s["layers"], bound):
        assert float(layer["w"].abs().max()) <= b
    s = weights.gat_params(torch.Generator().manual_seed(0), 6, 8, 3, 2, 2)
    p = gat.init(torch.Generator().manual_seed(0),
                 gat.GATConfig(6, 8, 3, n_layers=2, n_heads=2))
    assert [{k: v.shape for k, v in l.items()} for l in s["layers"]] == \
        [{k: v.shape for k, v in l.items()} for l in p["layers"]]


def test_host_merge_of_eight_is_exact():
    from gist_tpu_torch.ist.ultrawide import merge_host
    full = weights.sage_params(torch.Generator().manual_seed(8), 6, 16, 3, 2)
    np_full = {"layers": [{key: v.numpy().copy() for key, v in l.items()}
                          for l in full["layers"]]}
    bnds = models.boundaries_host(np.random.default_rng(1),
                                  models.boundary_sizes("sage", 6, 16, 2), 8)
    g = torch.Generator().manual_seed(9)
    trained = {"layers": [
        {key: torch.randn((8,) + tuple(models.dispatch(
            "sage", full, bnds, 0)["layers"][i][key].shape), generator=g)
         for key in l} for i, l in enumerate(full["layers"])]}
    ref = models.merge("sage", full, bnds, trained)
    merge_host(np_full, bnds, {"layers": [
        {key: v.numpy() for key, v in l.items()}
        for l in trained["layers"]]}, 8, "sage")
    for lp, lr in zip(np_full["layers"], ref["layers"]):
        for key in lr:
            np.testing.assert_array_equal(lp[key], lr[key].numpy())
