"""The port's experiment layer against the JAX package's: the sweep
registry and runner (``gist_tpu_torch.sweeps``), ``_run_one``'s
dispatch to each trainer on synth-tiny on the CPU, the figures
(``gist_tpu_torch.plotting``), and the small helpers the sweeps' trainers
share (``sym_norm``, ``inv_degree_norm``, ``print_reference_summary``)."""

import json
import math

import numpy as np
import pytest

import gist_tpu.graph as JG
from conftest import make_random_graph
from gist_tpu.sweeps import configs as jconfigs
from gist_tpu.sweeps import runner as jrunner
from gist_tpu.train.common import \
    print_reference_summary as jax_summary_lines

import gist_tpu_torch.graph as TG
from gist_tpu_torch import plotting
from gist_tpu_torch.sweeps import configs, run, runner
from gist_tpu_torch.train.common import print_reference_summary
from torch_port_helpers import load_jax_partitioner


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


@pytest.mark.parametrize("axes", [
    {}, {"a": [1, 2, 3]}, {"a": [1, 2], "b": ["x", "y", "z"]},
    {"a": [], "b": [1]}])
def test_grid_equal(axes):
    assert list(runner.grid(**axes)) == list(jrunner.grid(**axes))


def test_registry_names_equal():
    assert sorted(configs.SWEEPS) == sorted(jconfigs.SWEEPS)


@pytest.mark.parametrize("name", sorted(jconfigs.SWEEPS))
def test_registry_grid_equal(name):
    """Config for config, in order, with the default dataset and with
    an override."""
    assert list(configs.SWEEPS[name]()) == list(jconfigs.SWEEPS[name]())
    assert (list(configs.SWEEPS[name](dataset="synth-tiny"))
            == list(jconfigs.SWEEPS[name](dataset="synth-tiny")))


def _flaky(fail_on):
    calls = []

    def fn(*, x, trial):
        calls.append((x, trial))
        if x in fail_on:
            raise ValueError(f"bad x {x}")
        return {"best_test": x / 10 + trial / 100, "x": x}
    return fn, calls


def test_runner_resume_and_error_records(tmp_path):
    """Errors are recorded, not raised; a rerun skips what succeeded and
    retries what failed."""
    out = str(tmp_path / "sub" / "s.jsonl")
    fn, calls = _flaky({2})
    recs = runner.SweepRunner(fn, out, trials=2).run(
        [{"x": 1}, {"x": 2}], verbose=False)
    assert [r["status"] for r in recs] == ["ok", "ok", "error", "error"]
    assert "bad x 2" in recs[2]["error"] and "Traceback" in recs[2][
        "traceback"]
    assert all(r["hardware"] == "cpu" and r["wall_s"] >= 0 for r in recs)
    lines = [json.loads(l) for l in open(out)]
    assert [l["status"] for l in lines] == ["ok", "ok", "error", "error"]
    fn2, calls2 = _flaky(set())
    again = runner.SweepRunner(fn2, out, trials=2).run(
        [{"x": 1}, {"x": 2}], verbose=False)
    assert calls2 == [(2, 0), (2, 1)]
    assert [r["status"] for r in again] == ["ok", "ok"]
    assert runner.SweepRunner(fn2, out, trials=2).run(
        [{"x": 1}, {"x": 2}], verbose=False) == []
    # the key is the JAX runner's, so either runner resumes the other's
    assert runner.SweepRunner._key({"x": 1}, 0) == \
        jrunner.SweepRunner._key({"x": 1}, 0)


def test_summarize_equal(tmp_path):
    out = str(tmp_path / "s.jsonl")
    fn, _ = _flaky({3})
    runner.SweepRunner(fn, out, trials=3).run(
        [{"x": 1}, {"x": 2}, {"x": 3}], verbose=False)
    with open(out, "a") as f:   # the full-graph trainers' metric name
        f.write(json.dumps({"key": "k", "config": {"x": 9}, "trial": 0,
                            "status": "ok",
                            "result": {"best_test_acc": 0.05}}) + "\n")
    got = runner.summarize(out)
    assert got == jrunner.summarize(out)
    assert [r["config"]["x"] for r in got] == [2, 1, 9]
    assert got[0]["n"] == 3 and math.isclose(got[0]["mean"], 0.21)
    assert runner.summarize(out, "x") == jrunner.summarize(out, "x")


TINY = dict(dataset="synth-tiny", n_hidden=8, n_epochs=2, lr=1e-2)


@pytest.mark.parametrize("branch,config,marker", [
    ("full_graph", dict(n_layers=1), "kteps"),
    ("ist_simulation", dict(n_layers=2, num_subnet=2, iter_per_site=2),
     "val_accs"),
    ("cluster_scan", dict(n_layers=1, psize=4, batch_size=2),
     "steady_epoch_s"),
    ("ist_cluster", dict(n_layers=2, num_subnet=2, iter_per_site=2,
                         psize=4, batch_size=2), "num_subnet"),
    ("lsgd", dict(n_layers=2, num_subnet=2, iter_per_site=2, psize=4,
                  batch_size=2, lsgd=True), "num_subnet"),
    ("ultra_wide", dict(n_layers=1, num_subnet=2, iter_per_site=2, psize=4,
                        batch_size=2, ultra_wide=True), "round_wall_s"),
    ("gat", dict(n_heads=2, num_subnet=2, iter_per_site=2, psize=4,
                 batch_size=2), "num_subnet")])
def test_run_one_reaches_each_trainer(monkeypatch, branch, config, marker):
    """``_run_one`` dispatches as the JAX package's does; the Cluster-GCN
    branch trains with ``scan_batches=True``."""
    import gist_tpu_torch.ist.simulate as sim
    import gist_tpu_torch.train.cluster as cl
    import gist_tpu_torch.train.full_graph as fg
    import gist_tpu_torch.train.ist_cluster as ic
    import gist_tpu_torch.train.ist_ultrawide as uw
    seen = []
    for mod, name in ((fg, "train_full_graph"),
                      (sim, "train_ist_simulation"),
                      (cl, "train_cluster_gcn"),
                      (ic, "train_ist_cluster"),
                      (uw, "train_ist_ultrawide")):
        def spy(*a, _f=getattr(mod, name), _n=name, **kw):
            seen.append((_n, kw))
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    res = run._run_one(**TINY, **config, device="cpu")
    want = {"full_graph": "train_full_graph",
            "ist_simulation": "train_ist_simulation",
            "cluster_scan": "train_cluster_gcn",
            "ultra_wide": "train_ist_ultrawide"}.get(branch,
                                                     "train_ist_cluster")
    assert [n for n, _ in seen] == [want]
    kw = seen[0][1]
    assert str(kw["device"]) == "cpu"
    if branch == "cluster_scan":
        assert kw["scan_batches"] is True
    if branch == "lsgd":
        assert kw["lsgd"] is True
    if branch == "gat":
        assert kw["kind"] == "gat"
    assert marker in res
    assert all(math.isfinite(v) for v in res["losses"])


def test_sweep_cli_writes_jsonl_that_summarize_and_plots_read(
        tmp_path, monkeypatch, capsys):
    """``python -m gist_tpu_torch.sweeps.run --sweep reddit-baseline
    --dataset synth-tiny --limit 1 --device cpu`` with the grid cut to 2
    epochs and width 16 (the test's time), then ``summarize`` and both
    figures from its JSONL, and a rerun that resumes."""
    base = configs.SWEEPS["reddit-baseline"]
    monkeypatch.setitem(configs.SWEEPS, "reddit-baseline", lambda **kw: [
        {**c, "n_epochs": 2, "n_hidden": 16, "psize": 8, "batch_size": 2}
        for c in base(**kw)])
    out = str(tmp_path / "r.jsonl")
    argv = ["--sweep", "reddit-baseline", "--dataset", "synth-tiny",
            "--limit", "1", "--device", "cpu", "--out", out]
    records, rows = run.main(argv)
    assert [r["status"] for r in records] == ["ok"]
    assert records[0]["config"]["n_layers"] == 1
    assert all(math.isfinite(v) for v in records[0]["result"]["losses"])
    assert rows == runner.summarize(out) == jrunner.summarize(out)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(rows[0]))
    assert run.main(argv)[0] == []          # resumed: nothing to run
    png = plotting.save_sweep_curves(out, str(tmp_path / "s.png"),
                                     x="n_layers")
    assert open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    res = tmp_path / "one.json"
    res.write_text(json.dumps(records[0]["result"]))
    plotting.main(["run", str(res)])
    assert (tmp_path / "one.png").stat().st_size > 0


def test_plotting_run_and_sweep_figures(tmp_path):
    run_png = plotting.save_run_curve(
        {"val_accs": [0.1, 0.5, 0.6], "test_accs": [0.1, 0.4, 0.55],
         "losses": [2.0, 1.0, 0.5], "dataset": "d"}, str(tmp_path / "r.png"))
    assert open(run_png, "rb").read(4) == b"\x89PNG"
    jsonl = tmp_path / "s.jsonl"
    with open(jsonl, "w") as f:
        for k in (1, 2, 4):
            for ips, acc in ((10, 0.5), (20, 0.6)):
                for trial in range(2):
                    f.write(json.dumps({
                        "config": {"num_subnet": k, "iter_per_site": ips},
                        "status": "ok", "trial": trial,
                        "result": {"best_test": acc + k / 100 + trial / 50}}
                    ) + "\n")
        f.write(json.dumps({"config": {"num_subnet": 8}, "status": "error"})
                + "\n")
    plotting.main(["sweep", str(jsonl), "--x", "num_subnet", "--group",
                   "iter_per_site"])
    assert (tmp_path / "s.png").stat().st_size > 0
    with pytest.raises(ValueError, match="no rows"):
        plotting.save_sweep_curves(str(jsonl), str(tmp_path / "x.png"),
                                   x="nope")


@pytest.mark.parametrize("isolated", [False, True])
def test_degree_norms_equal(rng, isolated):
    n = 60
    s, r = make_random_graph(rng, n, 200, self_loops=not isolated)
    if isolated:    # nodes 0-9 receive nothing: their norm is 0
        keep = r >= 10
        s, r = s[keep], r[keep]
    jg = JG.graph_from_edges(s, r, n)
    tg = TG.graph_from_edges(s, r, n)
    for jf, tf in ((JG.sym_norm, TG.sym_norm),
                   (JG.inv_degree_norm, TG.inv_degree_norm)):
        got, want = tf(tg).numpy(), np.asarray(jf(jg))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert got.dtype == np.float32
        if isolated:
            assert (got[:10] == 0).all() and (got[10:] > 0).all()


@pytest.mark.parametrize("results", [
    {"train_time": 12.345678, "val_accs": [0.1, 0.3, 0.2],
     "test_accs": [0.15, 0.25, 0.35]},
    {"val_accs": [0.5]}, {"train_time": 1.0, "val_accs": [],
                          "test_accs": [0.9]}, {}])
def test_print_reference_summary_text(capsys, results):
    jax_summary_lines(results)
    want = capsys.readouterr().out
    print_reference_summary(results)
    assert capsys.readouterr().out == want
