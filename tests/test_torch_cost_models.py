"""The Amazon2M cost models (``bench/amazon_split_analysis.py``,
``bench/amazon_tn_analysis.py``) against the JAX scripts' ``analyze``
and ``model``: on a small graph and a permutation drawn from a seed,
the counts are array-equal, and at the JAX scripts' own constants,
passed here as arguments, the modelled walls equal theirs (which JAX
rounds).  The scripts end to end on synth-tiny on the CPU, with their
rates given and measured."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest

from gist_tpu_torch.bench import amazon_split_analysis as SA
from gist_tpu_torch.bench import amazon_tn_analysis as TA

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the JAX scripts' constants, as arguments of the port's models only
JAX_RATES = dict(gather_rows_per_s=85e6, stream_bytes_per_s=195e9,
                 permute_s=0.042)
JAX_BUDGET_GIB = 11.0


def _jax(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _graph(seed, n=9000, e=150000):
    """A graph with local structure, so that some (tile, block) pairs
    are dense, and a node -> row order drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = np.where(rng.random(e) < 0.8, (s + rng.integers(-600, 600, e)) % n,
                 rng.integers(0, n, e))
    # a locality order, shuffled by a seeded jitter
    order = np.argsort(np.arange(n) + rng.normal(0.0, 300.0, n))
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    return s, r, pos


@pytest.mark.parametrize("tn", [64, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_counts_match_jax_analyze(tn, seed, capsys):
    s, r, pos = _graph(seed)
    thresholds = [2, 4, 8, 16, 32, 64]
    want = _jax("amazon_split_analysis").analyze(tn, s, r, pos, thresholds)
    printed = capsys.readouterr().out.splitlines()[0]
    pairs, slots, rows = SA.split_counts(tn, s, r, pos, thresholds)
    assert f"pairs={pairs} unique_slots={slots}" in printed
    assert any(row["direct_jobs"] for row in rows)    # the split happens
    assert [row["T"] for row in rows] == [w["T"] for w in want]
    np.testing.assert_array_equal(
        [[row[k] for k in ("direct_jobs", "remote_slots", "remote_jobs")]
         for row in rows],
        [[w[k] for k in ("direct_jobs", "remote_slots", "remote_jobs")]
         for w in want])
    np.testing.assert_array_equal([round(row["w_gib"], 2) for row in rows],
                                  [w["w_gib"] for w in want])
    for row, w in zip(rows, want):
        wall = SA.split_wall(row, tn, len(s), **JAX_RATES)
        assert {k: round(v) for k, v in wall.items()} == {
            k: w[k] for k in ("t_gather_ms", "t_pipe_ms", "t_total_ms",
                              "edges_per_s_M")}


@pytest.mark.parametrize("seed", [0, 1])
def test_tn_counts_match_jax_model(seed, capsys):
    s, r, pos = _graph(seed)
    s_p, r_p = pos[s], pos[r]
    jmodel = _jax("amazon_tn_analysis").model
    for tn, thresholds in TA.PLAN:
        thresholds = tuple(None if t is None else 8 for t in thresholds)
        want = jmodel(tn, s_p, r_p, thresholds=thresholds)
        got = TA.tn_counts(tn, s_p, r_p, thresholds)
        assert [(g["tn"], g["T"]) for g in got] == [(w["tn"], w["T"])
                                                    for w in want]
        np.testing.assert_array_equal(
            [[g["rem_jobs"], g["direct_jobs"], round(g["slots_M"], 1),
              round(g["w_gib"], 2)] for g in got],
            [[w["rem_jobs"], w["direct_jobs"], w["slots_M"], w["w_gib"]]
             for w in want])
        for g, w in zip(got, want):
            wall = TA.tn_wall(g, len(s), budget_gib=JAX_BUDGET_GIB,
                              **JAX_RATES)
            assert wall["fits"] == w["fits"]
            assert {k: round(wall[k]) for k in (
                "t_gather_ms", "t_pipe_ms", "t_total_ms", "edges_per_s_M")} \
                == {k: w[k] for k in ("t_gather_ms", "t_pipe_ms",
                                      "t_total_ms", "edges_per_s_M")}
    capsys.readouterr()


SMALL = ["--dataset", "synth-tiny", "--log2-chunk", "10", "--cache-dir", "",
         "--device", "cpu"]


def test_scripts_with_given_rates_measure_nothing(tmp_path, monkeypatch):
    """Every rate given: nothing is measured, each source reads
    ``given``, and the rows are the models' at those rates."""
    def refuse(*a, **k):
        raise AssertionError("measured a rate that was given")
    monkeypatch.setattr(SA, "measure_rates", refuse)
    rates = ["--gather-rows-per-s", "1e8", "--stream-bytes-per-s", "2e11",
             "--permute-s", "0.01"]
    out = tmp_path / "split.json"
    assert SA.main([*SMALL, *rates, "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["rates"] == {"gather_rows_per_s": 1e8,
                            "gather_source": "given",
                            "stream_bytes_per_s": 2e11,
                            "stream_source": "given", "permute_s": 0.01,
                            "permute_source": "given"}
    assert [row["T"] for row in rec["rows"]] == list(SA.THRESHOLDS)
    assert rec["hardware"] == "cpu" and "Hopper" in rec["note"]
    out = tmp_path / "tn.json"
    assert TA.main([*SMALL, *rates, "--budget-gib", "3", "--out",
                    str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["rates"]["budget_gib"] == 3.0
    assert [(row["tn"], row["T"]) for row in rec["rows"]] == [
        (tn, t) for tn, ts in TA.PLAN for t in ts]


def test_scripts_measure_missing_rates(tmp_path):
    """Rates not given are measured on the device asked for (here the
    CPU, named so in each source), the budget from its memory."""
    out = tmp_path / "tn.json"
    assert TA.main([*SMALL, "--permute-s", "0.5", "--out", str(out)]) == 0
    rates = json.loads(out.read_text())["rates"]
    assert rates["permute_s"] == 0.5 and rates["permute_source"] == "given"
    for k in ("gather_rows_per_s", "stream_bytes_per_s", "budget_gib"):
        assert rates[k] > 0, k
    assert "a CPU run" in rates["gather_source"]
    assert "a CPU run" in rates["stream_source"]
    assert rates["budget_source"].startswith("host memory")


def test_scripts_raise_without_a_card_unless_asked_for_the_cpu(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["--dataset", "synth-tiny", "--cache-dir", "", "--out",
            str(tmp_path / "x.json")]
    assert SA.main(argv) == 1 and TA.main(argv) == 1
    assert not (tmp_path / "x.json").exists()
