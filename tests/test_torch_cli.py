"""The port's CLIs (``gist_tpu_torch/cli``) against the JAX package's
(``gist_tpu/cli``): each runs end to end with ``--device cpu`` on the
flags of its JAX counterpart and returns at least the JAX result keys
(the port adds its own timing keys).  ``infer`` on a port checkpoint
reproduces the trainer's last val accuracy exactly, and without a card
every CLI raises unless given ``--device cpu``."""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import load_jax_partitioner

MODEL = ["--dataset", "synth-tiny", "--n-hidden", "16"]
TINY = MODEL + ["--dropout", "0.2", "--n-epochs", "4", "--psize", "4",
                "--batch-size", "2"]
IST = ["--num_subnet", "2", "--iter_per_site", "2"]

CASES = {
    "ist_distrib": ("ist_distrib", TINY + IST),
    "ist_distrib_ultra_wide": ("ist_distrib",
                               TINY + IST + ["--ultra-wide", "--use-f1"]),
    "gat_distrib": ("gat_distrib", TINY + IST + ["--normalize"]),
    "cluster_gcn": ("cluster_gcn", MODEL + ["--n-epochs", "1", "--psize",
                                            "4", "--batch-size", "2"]),
    "train_gcn": ("train_gcn", ["--dataset", "synth-tiny", "--n-epochs",
                                "6", "--n-hidden", "16"]),
}


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _mains(name):
    return (importlib.import_module(f"gist_tpu.cli.{name}").main,
            importlib.import_module(f"gist_tpu_torch.cli.{name}").main)


def _finite(v):
    return all(np.isfinite(np.asarray(v, dtype=float)).ravel())


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_jax_result_keys(case, tmp_path):
    name, argv = CASES[case]
    jmain, tmain = _mains(name)
    want = jmain(argv)
    out = tmp_path / "r.json"
    got = tmain(argv + ["--device", "cpu", "--result-json", str(out)])
    assert set(want) <= set(got), set(want) - set(got)
    assert json.loads(out.read_text())["hardware"] == "cpu"
    for key in ("losses", "val_accs", "test_accs"):
        assert len(got[key]) == len(want[key]) and _finite(got[key]), key


@pytest.mark.parametrize("ultra_wide", [False, True])
def test_infer_reproduces_trainer(tmp_path, ultra_wide):
    from gist_tpu_torch.cli import infer, ist_distrib
    ck = str(tmp_path / "ck")
    flags = ["--normalize", "--device", "cpu"]
    trained = ist_distrib.main(TINY + IST + flags + ["--checkpoint-dir", ck]
                               + (["--ultra-wide"] if ultra_wide else []))
    logits = str(tmp_path / "logits.npy")
    got = infer.main(MODEL + flags + ["--checkpoint-dir", ck, "--logits-out",
                                      logits])
    assert got["val"] == trained["last_val"]
    assert got["test"] == trained["last_test"]
    assert got["checkpoint"].endswith("round_1")
    assert np.load(logits).shape == (256, 4)


def test_infer_matches_jax_keys_and_models(tmp_path):
    """JAX's infer on a JAX checkpoint and the port's on a port one of
    the same params give the same keys and scores; gcn and gat
    checkpoints load and score too."""
    import jax

    from gist_tpu.cli import infer as jinfer
    from gist_tpu.models import sage as jsage
    from gist_tpu.train.checkpoint import save_checkpoint as jsave

    from gist_tpu_torch.cli import infer
    from gist_tpu_torch.models import gat, gcn
    from gist_tpu_torch.train.checkpoint import save_checkpoint
    params = jsage.init(jax.random.PRNGKey(0), jsage.SAGEConfig(32, 16, 4))
    jck, tck = str(tmp_path / "jax"), str(tmp_path / "torch")
    jsave(f"{jck}/round_0", {"params": params, "round": 0})
    save_checkpoint(f"{tck}/round_0", {
        "params": jax.tree.map(np.asarray, params), "round": 0})
    base = MODEL + ["--use-f1"]
    want = jinfer.main(base + ["--checkpoint-dir", jck])
    got = infer.main(base + ["--checkpoint-dir", tck, "--cpu"])
    assert set(got) == set(want)
    assert got["val"] == want["val"] and got["test"] == want["test"]
    gen = torch.Generator().manual_seed(0)
    for model, mod, cfg in (
            ("gcn", gcn, gcn.GCNConfig(32, 16, 4)),
            ("gat", gat, gat.GATConfig(32, 16, 4))):
        path = str(tmp_path / model / "round_0")
        save_checkpoint(path, {"params": mod.init(gen, cfg), "round": 0})
        r = infer.main(base + ["--model", model, "--checkpoint-dir", path,
                               "--device", "cpu"])
        assert 0.0 <= r["val"] <= 1.0 and r["checkpoint"] == path


def test_train_gcn_profile_and_unported_flags(tmp_path):
    from gist_tpu_torch.cli import cluster_gcn, ist_distrib, train_gcn
    prof = tmp_path / "prof"
    train_gcn.main(["--dataset", "synth-tiny", "--n-epochs", "4",
                    "--profile-dir", str(prof), "--device", "cpu"])
    assert [f for f in os.listdir(prof) if f.endswith(".json")]
    with pytest.raises(NotImplementedError):
        train_gcn.main(["--dataset", "synth-tiny", "--scan-epochs", "2",
                        "--device", "cpu"])
    for flags in (["--use-pp"], ["--lsgd"], ["--use-pp", "--ultra-wide"]):
        with pytest.raises(NotImplementedError):
            ist_distrib.main(TINY + IST + flags + ["--device", "cpu"])
    with pytest.raises(NotImplementedError):
        cluster_gcn.main(TINY + ["--scan-batches", "--device", "cpu"])


@pytest.mark.parametrize("name", ["ist_distrib", "gat_distrib",
                                  "cluster_gcn", "train_gcn", "infer"])
def test_cli_defaults_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"gist_tpu_torch.cli.{name}").main
    argv = ["--dataset", "synth-tiny"]
    if name == "infer":
        argv += ["--checkpoint-dir", "missing"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_spmm_backend_names():
    import argparse

    from gist_tpu_torch.cli.common import add_common_args, apply_backend
    from gist_tpu_torch.ops import spmm
    p = argparse.ArgumentParser()
    add_common_args(p)
    try:
        for flag, want in (("pallas", "dedup"), ("segment", "segment"),
                           ("auto", "auto")):
            apply_backend(p.parse_args(["--spmm-backend", flag,
                                        "--device", "cpu"]))
            assert spmm._DEFAULT_BACKEND == want
    finally:
        spmm.set_default_backend("auto")
