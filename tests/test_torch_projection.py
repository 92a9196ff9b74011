"""The D-device scaling projections of the port against the JAX
package's, at the same explicit one-device time and link rate:
``ShardedGraph.projected_scaling``, ``bench/scaling_projection.py``'s
rows against the JAX script's own output, and the dry run's projection;
and the scripts that need a link rate refuse to run without one.

The link rates here are inputs, not figures of any card: 4.5e10 B/s is
the JAX method's default, passed so that the port's formula is held to
JAX's, and the others are arbitrary."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest

import gist_tpu.data as jdata
from gist_tpu.parallel import build_sharded_graph as j_build

from gist_tpu_torch import dryrun
from gist_tpu_torch.bench import scaling_projection
from gist_tpu_torch.data import load_dataset
from gist_tpu_torch.parallel import build_sharded_graph as t_build
from torch_port_helpers import load_jax_partitioner

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_LINK = 4.5e10          # gist_tpu's projected_scaling default
TINY = "synth-tiny"


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _graph(n, e, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = np.where(rng.random(e) < 0.7,
                 (s + rng.integers(-30, 30, e)) % n, rng.integers(0, n, e))
    return s, r


def _close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("rate", [JAX_LINK, 3.7e9])
def test_projected_scaling_matches_jax(d, rate):
    s, r = _graph(1500, 12000, d)
    gj = j_build(s, r, 1500, d, interior_tiles=False)
    gt = t_build(s, r, 1500, d, interior_tiles=False)
    for kw in ({}, {"halo_itemsize": 2}, {"itemsize": 2}):
        _close(gt.projected_scaling(2.5e-3, 64, link_bytes_per_s=rate, **kw),
               gj.projected_scaling(2.5e-3, 64, ici_bytes_per_s=rate, **kw))


def test_projected_scaling_has_no_default_link():
    s, r = _graph(300, 2000, 0)
    with pytest.raises(TypeError):
        t_build(s, r, 300, 2, interior_tiles=False).projected_scaling(1e-3, 8)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_scaling_projection", ROOT / "benchmarks" /
        "scaling_projection.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scaling_projection_rows_match_the_jax_script(tmp_path, monkeypatch,
                                                      capsys):
    """The JAX script run on synth-tiny (its dataset swapped in) at t1
    3.3 and 2.1 ms and its link rate, against the port's script at the
    same explicit t1 and rate: every row within 1e-12 relative."""
    real = jdata.synthetic_dataset
    monkeypatch.setattr(jdata, "synthetic_dataset",
                        lambda name, *a, **k: real(TINY, *a, **k))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "results").mkdir()
    _jax_script().main(["3.3", "2.1"])
    want = json.loads((tmp_path / "results" /
                       "r2_scaling_projection.json").read_text())
    monkeypatch.undo()
    out = tmp_path / "port.json"
    assert scaling_projection.main([
        "--dataset", TINY, "--device", "cpu", "--t1-ms", "3.3", "2.1",
        "--link-bytes-per-s", str(JAX_LINK), "--link-name",
        "the JAX default, as an input", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == got
    for k in ("f", "t1_agg_ms_fp32", "t1_agg_ms_bf16"):
        assert got[k] == want[k], k
    assert got["link_bytes_per_s"] == want["ici_bytes_per_s"]
    assert (got["t1_source"], got["link_name"]) == (
        "--t1-ms", "the JAX default, as an input")
    assert [p["n_devices"] for p in got["projections"]] == [2, 4, 8]
    for g, w in zip(got["projections"], want["projections"]):
        _close(g, w)


def test_scaling_projection_measures_t1_on_the_device():
    """Without ``--t1-ms`` the times are K1's, measured in the run (on
    the CPU the plain walk's wall clock), and the record says so."""
    rec = scaling_projection.run(load_dataset(TINY), "cpu",
                                 link_bytes_per_s=1e9,
                                 link_name="a test link", devices=[2],
                                 iters=2)
    assert rec["t1_agg_ms_fp32"] > 0 and rec["t1_agg_ms_bf16"] > 0
    assert rec["t1_source"].startswith("K1 forward on synth-tiny")
    assert rec["hardware"] == "cpu"
    assert [p["n_devices"] for p in rec["projections"]] == [2]


@pytest.mark.parametrize("argv", [
    [], ["--link-bytes-per-s", "1e9"], ["--link-name", "x"]])
def test_scaling_projection_refuses_without_a_link(argv, tmp_path):
    with pytest.raises(SystemExit):
        scaling_projection.main(["--dataset", TINY, "--device", "cpu",
                                 "--t1-ms", "1", "1", "--out",
                                 str(tmp_path / "x.json"), *argv])
    assert not (tmp_path / "x.json").exists()
    with pytest.raises(ValueError, match="link"):
        scaling_projection.run(None, "cpu", link_bytes_per_s=0,
                               link_name="x", t1_ms=(1, 1))


def test_dryrun_projection_matches_jax(tmp_path):
    """The dry run's projection of synth-tiny over 4 ranks, from an
    explicit t1 and from the port's own sharded record, against the JAX
    graph's projection at the same time and rate."""
    ds = jdata.synthetic_dataset(TINY)
    sg = j_build(ds.senders, ds.receivers, ds.n_nodes, 4,
                 interior_tiles=False)
    f = ds.features.shape[1]
    want = sg.projected_scaling(t1_agg_s=1.7e-3, f=f, ici_bytes_per_s=2e9)
    want16 = sg.projected_scaling(t1_agg_s=1.7e-3, f=f, halo_itemsize=2,
                                  ici_bytes_per_s=2e9)
    got = dryrun.projection(4, 2e9, "a test link", t1_ms=1.7)
    _close({k: got[k] for k in want}, want)
    assert got["efficiency_overlap_bf16_halo"] == pytest.approx(
        want16["efficiency_overlap"], rel=1e-12)
    assert (got["t1_source"], got["link_name"]) == ("--t1-ms", "a test link")

    rec = tmp_path / "torch_sharded.json"
    rec.write_text(json.dumps({"step": {
        "sharded_d1_kernel_ms": 1.7, "hardware": "a card",
        "power_limit_w": 100.0}}))
    got2 = dryrun.projection(4, 2e9, "a test link", t1_path=str(rec))
    _close({k: got2[k] for k in want}, want)
    assert got2["t1_source"].startswith(str(rec))
    with pytest.raises(FileNotFoundError):
        dryrun.projection(4, 2e9, "x", t1_path=str(tmp_path / "none.json"))


def test_dryrun_prints_the_projection_only_with_a_link(capsys):
    """Two CPU ranks: with a link rate the summary holds the projection
    and prints it; a rate without the link's name is refused."""
    res = dryrun.dryrun_multichip(2, device="cpu", timeout_s=300,
                                  link_bytes_per_s=1e9,
                                  link_name="a test link", t1_ms=0.5)
    assert res["projection"]["n_devices"] == 2
    assert "projected scaling @D=2" in capsys.readouterr().out
    with pytest.raises(ValueError, match="link"):
        dryrun.dryrun_multichip(2, device="cpu", link_bytes_per_s=1e9)
