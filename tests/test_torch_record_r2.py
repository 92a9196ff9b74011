"""``bench/record_r2.py`` against the JAX ``benchmarks/record_r2.py``:
the same runs in the same order with the same datasets, normalisation,
model configurations, ``TrainConfig`` and trainer keywords (the JAX
script run with its trainers replaced by recorders); one cut run, cora
GCN at 3 epochs with dropout 0 from the JAX initial parameters, holds
the JAX trainer's losses to 1e-5; the records are written as named and
the first failing run stops the script."""

import dataclasses
import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest

import gist_tpu.data as jdata
import gist_tpu.train.cluster as jcluster
import gist_tpu.train.full_graph as jfull
import gist_tpu.train.ist_ultrawide as juw
from gist_tpu.models import gcn as jgcn
from gist_tpu.train.common import TrainConfig as JTrainConfig

from gist_tpu_torch.bench import record_r2 as R
from gist_tpu_torch.data import load_dataset
from torch_port_helpers import load_jax_partitioner

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


class _StubDataset:
    """What the JAX script reads of a dataset: its widths and the
    normalisation it asks for."""

    def __init__(self, name):
        self.name, self.in_feats, self.n_classes = name, 17, 5
        self.normalized = False

    def normalize_features(self):
        self.normalized = True
        return self


def _jax_calls(monkeypatch, tmp_path, what):
    """The JAX script's trainer calls for ``what``, each as (trainer,
    dataset, normalised, model, config fields, TrainConfig fields,
    keywords)."""
    calls = []
    # each JAX trainer's default model
    default = {"full_graph": "gcn", "cluster": "sage", "ultrawide": "sage"}

    def recorder(trainer):
        def call(ds, cfg, tc, **kw):
            model = kw.pop("model", None)
            model = default[trainer] if model is None else \
                model.__name__.rsplit(".", 1)[-1]
            kw.pop("verbose", None)
            calls.append((trainer, ds.name, ds.normalized, model,
                          dataclasses.asdict(cfg), dataclasses.asdict(tc),
                          kw))
            return {"best_val_acc": 0.0}
        return call

    monkeypatch.setattr(jdata, "synthetic_dataset", _StubDataset)
    monkeypatch.setattr(jfull, "train_full_graph", recorder("full_graph"))
    monkeypatch.setattr(jcluster, "train_cluster_gcn", recorder("cluster"))
    monkeypatch.setattr(juw, "train_ist_ultrawide", recorder("ultrawide"))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "results").mkdir(exist_ok=True)
    spec = importlib.util.spec_from_file_location(
        "jax_record_r2", ROOT / "benchmarks" / "record_r2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if what in ("singles", "all"):
        mod.singles()
    if what.startswith("ultrawide:"):
        mod.ultrawide(only=what.split(":", 1)[1])
    elif what in ("ultrawide", "all"):
        mod.ultrawide()
    return calls


@pytest.mark.parametrize("what", ["all", "singles", "ultrawide",
                                  "ultrawide:2048,1", "ultrawide:64,2"])
def test_runs_and_hyperparameters_match_the_jax_script(what, monkeypatch,
                                                       tmp_path, capsys):
    want = _jax_calls(monkeypatch, tmp_path, what)
    capsys.readouterr()
    got = R.runs(what)
    assert len(got) == len(want)
    for run, (trainer, ds, norm, model, cfg, tc, kw) in zip(got, want):
        assert (run.trainer, run.dataset, run.normalize, run.model) == (
            trainer, ds, norm, model), run.name
        _, pcfg, ptc = R.configs(run, _StubDataset(ds))
        pcfg, ptc = dataclasses.asdict(pcfg), dataclasses.asdict(ptc)
        # every field the JAX config has, equal; the port's extra
        # fields (none in these configs) would stay at their defaults
        assert {k: pcfg[k] for k in cfg} == cfg, run.name
        assert {k: ptc[k] for k in tc} == tc, run.name
        assert run.kw == kw, run.name
    names = [f"r2_{r.name}" for r in got]
    jax_names = sorted(p.stem for p in (tmp_path / "results").iterdir())
    assert sorted(names) == jax_names


def test_unknown_mode_and_name_raise():
    with pytest.raises(ValueError, match="mode"):
        R.runs("nothing")
    with pytest.raises(ValueError, match="no run named"):
        R.record("singles", "cpu", only=["uw_h512_k8"])


def test_cut_cora_run_tracks_jax():
    """cora GCN (the JAX script's first run) at 3 epochs with dropout 0:
    the port's record from the JAX initial parameters against the JAX
    trainer: losses 1e-5 relative, accuracies within one validation
    node."""
    run = R.runs("singles")[0]
    assert run.name == "cora_gcn"
    jds = jdata.synthetic_dataset(run.dataset)
    jcfg = jgcn.GCNConfig(jds.in_feats, 256, jds.n_classes, n_layers=1,
                          dropout=0.0)
    jtc = JTrainConfig(lr=1e-2, weight_decay=5e-4, n_epochs=3,
                       lr_schedule=True)
    want = jfull.train_full_graph(jds, jcfg, jtc, scan_epochs=50,
                                  verbose=False)
    init = jax.tree.map(np.asarray, jgcn.init(jax.random.PRNGKey(jtc.seed),
                                              jcfg))
    got = R.train(run, load_dataset(run.dataset), "cpu", n_epochs=3,
                  dropout=0.0, init_params=init)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    n_val = int(jds.val_mask.sum())
    for k in ("val_accs", "test_accs"):
        np.testing.assert_allclose(got[k], want[k], atol=1.0 / n_val + 1e-7)
    assert set(want) <= set(got)
    assert got["config"]["n_hidden"] == 256 and got["config"]["dropout"] == 0
    assert got["config"]["tc_n_epochs"] == 3
    assert got["hardware"] == "cpu" and got["wall_time"] > 0


def test_record_writes_each_run_and_stops_at_a_failure(tmp_path, capsys,
                                                       monkeypatch):
    out = R.record("singles", "cpu", only=["cora_gcn"], n_epochs=2,
                   out_dir=str(tmp_path))
    rec = json.loads((tmp_path / "torch_r2_cora_gcn.json").read_text())
    assert rec == json.loads(json.dumps(out["cora_gcn"]))
    assert len(rec["losses"]) == 2 and rec["config"]["tc_n_epochs"] == 2
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["run"] == "r2_cora_gcn" and "wall_time" in line

    calls = []

    def fail(run, *a, **k):
        calls.append(run.name)
        raise RuntimeError("a run failed")
    monkeypatch.setattr(R, "train", fail)
    assert R.main(["singles", "--only", "cora_gcn", "reddit_full_float32",
                   "--device", "cpu", "--out", str(tmp_path / "b")]) == 1
    assert calls == ["cora_gcn"]
    assert not (tmp_path / "b").exists()
    assert "a run failed" in capsys.readouterr().out
