"""The port's checkpoints (``gist_tpu_torch/train/checkpoint.py``) and
the resume of its two IST trainers.

The format round-trips tensors, numbers and generator states bitwise;
``latest_round_dir`` picks the JAX package's round on the same tree.  A
run cut after a round and rerun with the same arguments reproduces the
uninterrupted run exactly (dropout on, so the restored generator state
counts), and with dropout 0 and the JAX package's initial params the
port's resumed ultra-wide run tracks the JAX package's resumed run."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from gist_tpu.data.synthetic import synthetic_dataset as jax_synth
from gist_tpu.models import sage as jsage
from gist_tpu.train import checkpoint as JCk
from gist_tpu.train.common import TrainConfig as JTC
from gist_tpu.train.ist_ultrawide import train_ist_ultrawide as j_uw

from gist_tpu_torch.data import load_dataset
from gist_tpu_torch.models import gat as tgat
from gist_tpu_torch.models import sage as tsage
from gist_tpu_torch.train import checkpoint as TCk
from gist_tpu_torch.train.common import TrainConfig as TTC
from gist_tpu_torch.train.ist_cluster import train_ist_cluster
from gist_tpu_torch.train.ist_ultrawide import train_ist_ultrawide
from torch_port_helpers import load_jax_partitioner


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def test_round_trip_is_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(11)
    torch.rand(5, generator=gen)                 # a state past its seed
    state = {
        "params": {"layers": [
            {"w": rng.standard_normal((4, 3)).astype(np.float32),
             "b": torch.randn(3, dtype=torch.float64)}]},
        "round": 7, "lr": 0.125, "tag": "sage",
        "gens": [TCk.generator_state(gen)],
    }
    path = str(tmp_path / "round_7")
    TCk.save_checkpoint(path, state)
    assert os.listdir(path) == [TCk.STATE_FILE]
    back = TCk.load_checkpoint(path)
    assert back["round"] == 7 and back["lr"] == 0.125
    assert back["tag"] == "sage"
    layer = back["params"]["layers"][0]
    assert isinstance(layer["w"], torch.Tensor)
    np.testing.assert_array_equal(layer["w"].numpy(),
                                  state["params"]["layers"][0]["w"])
    assert torch.equal(layer["b"], state["params"]["layers"][0]["b"])
    fresh = torch.Generator().manual_seed(0)
    TCk.restore_generator(fresh, back["gens"][0])
    assert torch.equal(torch.rand(8, generator=fresh),
                       torch.rand(8, generator=gen))
    host = TCk.params_to_host(back["params"])["layers"][0]["w"]
    assert host.dtype == np.float32 and host.flags.writeable


def test_save_replaces_and_skips_temporaries(tmp_path):
    path = str(tmp_path / "round_3")
    TCk.save_checkpoint(path, {"round": 3, "x": np.zeros(2)})
    TCk.save_checkpoint(path, {"round": 3, "x": np.ones(2)})
    np.testing.assert_array_equal(TCk.load_checkpoint(path)["x"].numpy(),
                                  np.ones(2))
    # a save cut before its rename leaves a temporary that no reader picks
    os.makedirs(tmp_path / "round_4.tmp123")
    assert TCk.latest_round_dir(str(tmp_path)) == path
    assert sorted(os.listdir(path)) == [TCk.STATE_FILE]


def test_generator_device_mismatch_raises():
    saved = {"device": "cuda", "state": torch.zeros(16, dtype=torch.uint8)}
    with pytest.raises(ValueError, match="'cuda' generator"):
        TCk.restore_generator(torch.Generator(), saved)


@pytest.mark.parametrize("names", [
    ["round_1", "round_10", "round_2", "round_x", "other", "round_3.tmp9"],
    ["round_", "round_a_1", "notes"],
    ["round_0"],
    [],
])
def test_latest_round_dir_matches_jax(tmp_path, names):
    for name in names:
        os.makedirs(tmp_path / name)
    assert TCk.latest_round_dir(str(tmp_path)) == \
        JCk.latest_round_dir(str(tmp_path))
    assert TCk.latest_round_dir(str(tmp_path / "missing")) is None


def _uw_cfg(dropout):
    return tsage.SAGEConfig(32, 16, 4, n_layers=1, dropout=dropout)


def _uw(tc, ck=None, dropout=0.3, **kw):
    return train_ist_ultrawide(load_dataset("synth-tiny"), _uw_cfg(dropout),
                               tc, psize=4, batch_size=2, verbose=False,
                               checkpoint_dir=ck, device="cpu", **kw)


def _tc(n_epochs):
    return TTC(lr=3e-2, weight_decay=0.0, n_epochs=n_epochs, num_subnet=2,
               iter_per_site=2)


def test_ultrawide_resume_equals_uninterrupted(tmp_path):
    """The resumed call returns the whole run's record: the cut call's
    rounds as it returned them, then its own, equal to the uninterrupted
    run's."""
    ck = str(tmp_path / "uw")
    full = _uw(_tc(8))
    cut = _uw(_tc(4), ck)
    assert len(cut["losses"]) == 2 < len(full["losses"])
    resumed = _uw(_tc(8), ck)
    for key in ("losses", "val_accs", "test_accs", "eval_rounds"):
        assert resumed[key][:2] == cut[key], key
        assert resumed[key] == full[key], key
    for key in ("round_wall_s", "train_time_at_eval", "rss_gb"):
        assert resumed[key][:2] == cut[key], key
        assert len(resumed[key]) == len(full[key]), key
    assert resumed["train_time"] >= cut["train_time"]
    prog = json.loads((tmp_path / "uw" / "progress.json").read_text())
    assert prog["round"] == 3 and prog["losses"] == resumed["losses"]
    assert len(prog["rss_gb"]) == len(prog["loadavg_1m"]) == 4
    # a finished run's checkpoint: nothing trained, its record returned
    again = _uw(_tc(8), ck)
    for key in ("losses", "val_accs", "test_accs", "round_wall_s"):
        assert again[key] == resumed[key], key


def test_ultrawide_resume_tracks_jax(tmp_path):
    """dropout 0 and the JAX package's initial params: both packages cut
    after round 1 and resume to round 3; the port's tail tracks JAX's."""
    jcfg = jsage.SAGEConfig(32, 16, 4, n_layers=1, dropout=0.0)
    init = jax.tree.map(np.asarray, jsage.init(jax.random.PRNGKey(0), jcfg))
    common = dict(psize=4, batch_size=2, verbose=False)
    jtc = [JTC(lr=3e-2, weight_decay=0.0, n_epochs=n, num_subnet=2,
               iter_per_site=2) for n in (4, 8)]
    jck = str(tmp_path / "jax")
    jcut = j_uw(jax_synth("synth-tiny"), jcfg, jtc[0], sequential=True,
                checkpoint_dir=jck, **common)
    jres = j_uw(jax_synth("synth-tiny"), jcfg, jtc[1], sequential=True,
                checkpoint_dir=jck, **common)
    tck = str(tmp_path / "torch")
    tcut = _uw(_tc(4), tck, dropout=0.0, init_params=init)
    tres = _uw(_tc(8), tck, dropout=0.0, init_params=init)
    # the port's resumed call returns the whole run, JAX's its own rounds
    assert len(jres["losses"]) == 2 and len(tres["losses"]) == 4
    assert tres["losses"][:2] == tcut["losses"]
    np.testing.assert_allclose(tres["losses"],
                               jcut["losses"] + jres["losses"], rtol=1e-4)
    n_val = int(load_dataset("synth-tiny").val_mask.sum())
    np.testing.assert_allclose(tres["val_accs"][2:], jres["val_accs"],
                               atol=1.0 / n_val + 1e-9)


def _cluster(kind, n_epochs, ck=None):
    ds = load_dataset("synth-tiny")
    if kind == "gat":
        cfg, model = tgat.GATConfig(ds.in_feats, 16, ds.n_classes), tgat
    else:
        cfg = tsage.SAGEConfig(ds.in_feats, 16, ds.n_classes, n_layers=1,
                               dropout=0.3)
        model = tsage
    tc = TTC(lr=3e-2, weight_decay=0.0, n_epochs=n_epochs, num_subnet=2,
             iter_per_site=1)
    return train_ist_cluster(ds, cfg, tc, psize=4, batch_size=2,
                             model=model, kind=kind, checkpoint_dir=ck,
                             verbose=False, device="cpu")


@pytest.mark.parametrize("kind", ["sage", "gat"])
def test_ist_cluster_resume_equals_uninterrupted(tmp_path, kind):
    """Rounds of one step and an eval every 2 steps: the cut run saves
    after rounds 1 and 3, and the resumed run keeps the eval cadence."""
    ck = str(tmp_path / kind)
    full = _cluster(kind, 8)
    cut = _cluster(kind, 4, ck)
    assert os.path.basename(TCk.latest_round_dir(ck)) == "round_3"
    resumed = _cluster(kind, 8, ck)
    assert len(full["losses"]) == 8
    for key in ("losses", "val_accs", "test_accs"):
        assert cut[key] + resumed[key] == full[key], key
    again = _cluster(kind, 8, ck)
    assert np.isnan(again["losses"]).all()
    assert again["val_accs"] == [full["val_accs"][-1]]
