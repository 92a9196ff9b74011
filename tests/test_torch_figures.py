"""The round-4 and round-5 figure scripts (``bench/r4_figures.py``,
``bench/r5_figures.py``) render each figure from records with the keys
the JAX figures read, and skip a figure whose records are absent.
matplotlib is not on the card's machine: these tests need it and skip
without it."""

import json

import pytest

pytest.importorskip("matplotlib")

from gist_tpu_torch.bench import r4_figures, r5_figures  # noqa: E402


def _uw(rounds):
    return {"dataset": "synth-amazon2m", "hardware": "a card",
            "val_accs": [0.5 + 0.01 * r for r in range(rounds)],
            "eval_rounds": list(range(rounds)),
            "train_time_at_eval": [10.0 * (r + 1) for r in range(rounds)],
            "config": {"lr": 0.01}}


RECORDS = {
    "torch_ist_sharded_2d.json": {
        "dataset": "synth-reddit-small", "mesh": [2, 4], "hardware": "a card",
        "curves": {t: {"val": [0.3, 0.5, 0.6], "wall": [2.0, 1.5, 1.4],
                       "test": [0.3, 0.5, 0.6], "loss": [3.0, 2.0, 1.5]}
                   for t in ("2d", "1d")}},
    "torch_amazon_uw_fullscale_h512_k8.json": _uw(4),
    "torch_amazon_uw_fullscale_h2048_k1.json": _uw(3),
    "torch_amazon_uw_fullscale_h2048_k2.json": _uw(2),
    "torch_sharded_gcn_reddit.json": {
        "dataset": "synth-reddit-small", "n_devices": 8,
        "val_accs": [0.4, 0.6], "best_val_acc": 0.6},
}


def _write(tmp_path, names):
    for name in names:
        (tmp_path / name).write_text(json.dumps(RECORDS[name]))


def test_r4_figures_from_records(tmp_path, capsys):
    _write(tmp_path, RECORDS)
    got = r4_figures.main(["--results", str(tmp_path)])
    assert [p.rsplit("/", 1)[-1] for p in got] == [
        "torch_r4_ist_sharded_2d.png", "torch_r4_amazon_uw_family.png",
        "torch_r4_sharded_models.png"]
    for p in got:
        assert (tmp_path / p.rsplit("/", 1)[-1]).stat().st_size > 1000
    assert capsys.readouterr().out.count("wrote ") == 3


def test_r5_figures_from_records(tmp_path):
    _write(tmp_path, RECORDS)
    got = r5_figures.main(["--results", str(tmp_path)])
    assert [p.rsplit("/", 1)[-1] for p in got] == [
        "torch_r5_amazon_uw_family_chip.png", "torch_r5_ist_sharded_2d.png"]
    for p in got:
        assert (tmp_path / p.rsplit("/", 1)[-1]).stat().st_size > 1000


def test_figures_skip_what_is_absent(tmp_path):
    assert r4_figures.main(["--results", str(tmp_path)]) == []
    assert r5_figures.main(["--results", str(tmp_path)]) == []
    assert list(tmp_path.iterdir()) == []
    _write(tmp_path, ["torch_sharded_gcn_reddit.json"])
    assert [p.rsplit("/", 1)[-1] for p in r4_figures.main(
        ["--results", str(tmp_path)])] == ["torch_r4_sharded_models.png"]
    assert r5_figures.main(["--results", str(tmp_path)]) == []
