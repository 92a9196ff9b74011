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
    "train_ist": ("train_ist", MODEL + ["--n-epochs", "6"] + IST),
    "train_ist_fused": ("train_ist", MODEL + ["--n-epochs", "6", "--fused"]
                        + IST),
    "ist_distrib_lsgd": ("ist_distrib", TINY + IST + ["--lsgd"]),
    "ist_distrib_use_pp": ("ist_distrib", TINY + IST + ["--use-pp"]),
    "ist_distrib_ultra_wide_use_pp": ("ist_distrib", TINY + IST
                                      + ["--ultra-wide", "--use-pp"]),
    "cluster_gcn_use_pp": ("cluster_gcn", MODEL + [
        "--n-epochs", "1", "--psize", "4", "--batch-size", "2",
        "--use-pp"]),
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
    from gist_tpu_torch.cli import cluster_gcn, train_gcn
    prof = tmp_path / "prof"
    train_gcn.main(["--dataset", "synth-tiny", "--n-epochs", "4",
                    "--profile-dir", str(prof), "--device", "cpu"])
    assert [f for f in os.listdir(prof) if f.endswith(".json")]
    # the epoch scans: the trainers' result keys, and the scan's own
    loop = train_gcn.main(["--dataset", "synth-tiny", "--n-epochs", "5",
                           "--device", "cpu"])
    scan = train_gcn.main(["--dataset", "synth-tiny", "--n-epochs", "5",
                           "--scan-epochs", "2", "--device", "cpu"])
    assert set(scan) == set(loop) | {"scan_epochs"}
    assert scan["scan_epochs"] == 2 and len(scan["losses"]) == 5
    np.testing.assert_allclose(scan["losses"], loop["losses"], rtol=1e-5)
    no_dropout = TINY + ["--dropout", "0", "--device", "cpu"]
    loop = cluster_gcn.main(no_dropout)
    scan = cluster_gcn.main(no_dropout + ["--scan-batches"])
    assert set(scan) == set(loop)
    np.testing.assert_allclose(scan["losses"], loop["losses"], rtol=1e-5)


def test_infer_multitask_matches_jax(tmp_path, monkeypatch):
    """On a multitask dataset (multi-hot labels, here a thresholded
    projection of synth-tiny's features) both infers score the same
    params with the threshold micro-F1."""
    import jax

    import gist_tpu.data as jdata
    from gist_tpu.cli import infer as jinfer
    from gist_tpu.models import sage as jsage
    from gist_tpu.train.checkpoint import save_checkpoint as jsave

    import gist_tpu_torch.data as tdata
    from gist_tpu_torch.cli import infer
    from gist_tpu_torch.models.common import micro_f1
    from gist_tpu_torch.train.checkpoint import save_checkpoint

    def multitask(load):
        def wrapped(name, *a, **kw):
            ds = load(name)
            w = np.random.default_rng(1).standard_normal((ds.in_feats, 6))
            ds.labels_multi = (ds.features @ w > 0).astype(np.float32)
            ds.labels = ds.labels_multi.argmax(axis=1).astype(np.int32)
            ds.n_classes = 6
            return ds
        return wrapped
    monkeypatch.setattr(jdata, "load_dataset",
                        multitask(jdata.load_dataset))
    monkeypatch.setattr(tdata, "load_dataset",
                        multitask(tdata.load_dataset))
    params = jsage.init(jax.random.PRNGKey(0), jsage.SAGEConfig(32, 16, 6))
    jck, tck = str(tmp_path / "jax"), str(tmp_path / "torch")
    jsave(f"{jck}/round_0", {"params": params, "round": 0})
    save_checkpoint(f"{tck}/round_0", {
        "params": jax.tree.map(np.asarray, params), "round": 0})
    logits = str(tmp_path / "logits.npy")
    want = jinfer.main(MODEL + ["--checkpoint-dir", jck])
    got = infer.main(MODEL + ["--checkpoint-dir", tck, "--device", "cpu",
                              "--logits-out", logits])
    assert got["val"] == want["val"] and got["test"] == want["test"]
    ds = tdata.load_dataset("synth-tiny")
    assert got["val"] == micro_f1(np.load(logits), ds.labels_multi,
                                  ds.val_mask, multitask=True)


@pytest.mark.parametrize("name", ["ist_distrib", "gat_distrib",
                                  "cluster_gcn", "train_gcn", "infer",
                                  "train_ist"])
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
