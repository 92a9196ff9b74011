"""The port's single-device IST simulation (``ist/simulate.py``) and its
CLI (``cli/train_ist.py``) against the JAX package's, loop and fused,
for kinds gcn and sage.

``jax.random`` and torch draw different partitions and initial
parameters, so the port gets the JAX trainer's: its ``init`` output and
the boundaries its partition key gives each round.  Dropout is 0.
Losses agree to rtol 1e-4 (summation order, amplified by Adam over
steps) and accuracies to one validation (test) node."""

import jax
import numpy as np
import pytest
import torch

from gist_tpu.data.synthetic import synthetic_dataset as jax_synth
from gist_tpu.ist import partition as JPart
from gist_tpu.ist.simulate import train_ist_simulation as j_sim
from gist_tpu.models import gcn as jgcn
from gist_tpu.models import sage as jsage
from gist_tpu.train.common import TrainConfig as JTC

from gist_tpu_torch.data import load_dataset
from gist_tpu_torch.ist import simulate as TSim
from gist_tpu_torch.models import gcn as tgcn
from gist_tpu_torch.models import sage as tsage
from gist_tpu_torch.train.common import TrainConfig as TTC
from torch_port_helpers import load_jax_partitioner


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _jax_boundaries(seed, sizes, k, n_rounds):
    """The boundaries the JAX trainer draws: one split of its partition
    key (seed + 1) a round, as torch index tensors."""
    key, rounds = jax.random.PRNGKey(seed + 1), []
    for _ in range(n_rounds):
        key, sk = jax.random.split(key)
        rounds.append([None if b is None else torch.from_numpy(
            np.array(b)).long() for b in JPart.sample_boundaries(sk, sizes,
                                                                 k)])
    return rounds


def _inject(monkeypatch, rounds):
    monkeypatch.setattr(TSim, "sample_boundaries",
                        lambda gen, sizes, k: rounds.pop(0))


def _hold(rj, rt, ds):
    assert len(rt["losses"]) == len(rj["losses"])
    np.testing.assert_allclose(rt["losses"], rj["losses"], rtol=1e-4)
    np.testing.assert_allclose(rt["val_accs"], rj["val_accs"],
                               atol=1.0 / int(ds.val_mask.sum()) + 1e-9)
    np.testing.assert_allclose(rt["test_accs"], rj["test_accs"],
                               atol=1.0 / int(ds.test_mask.sum()) + 1e-9)
    assert set(rj) <= set(rt), set(rj) - set(rt)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_simulation_matches_jax(kind, fused, monkeypatch):
    """7 epochs at iter_per_site 3: two full rounds and a tail of one,
    split input and output, K=2."""
    k, hidden, ips, n_epochs = 2, 16, 3, 7
    ds_t = load_dataset("synth-tiny")
    args = (ds_t.in_feats, hidden, ds_t.n_classes)
    if kind == "gcn":
        jcfg = jgcn.GCNConfig(*args, n_layers=2, dropout=0.0)
        tcfg = tgcn.GCNConfig(*args, n_layers=2, dropout=0.0)
        jm, tm = jgcn, tgcn
    else:
        jcfg = jsage.SAGEConfig(*args, n_layers=2, dropout=0.0)
        tcfg = tsage.SAGEConfig(*args, n_layers=2, dropout=0.0)
        jm, tm = jsage, tsage
    kw = dict(lr=1e-2, weight_decay=5e-4, n_epochs=n_epochs, num_subnet=k,
              iter_per_site=ips, split_input=True, split_output=True)
    rj = j_sim(jax_synth("synth-tiny"), jcfg, JTC(**kw), model=jm,
               kind=kind, fused=fused, verbose=False)
    sizes = JPart.boundary_sizes(ds_t.in_feats, hidden, 2, split_input=True,
                                 split_output=True)
    rounds = _jax_boundaries(JTC().seed, sizes, k, 3)
    _inject(monkeypatch, rounds)
    init = _np_tree(jm.init(jax.random.PRNGKey(JTC().seed), jcfg))
    rt = TSim.train_ist_simulation(ds_t, tcfg, TTC(**kw), model=tm,
                                   kind=kind, fused=fused, init_params=init,
                                   device="cpu", verbose=False)
    assert not rounds
    assert len(rt["losses"]) == (3 if fused else n_epochs)
    assert rt.get("fused", False) == fused
    _hold(rj, rt, ds_t)


def test_loop_round_means_equal_fused(monkeypatch):
    """The loop's per-epoch losses, averaged over each round, are the
    fused mode's round losses: the two modes train the same rounds."""
    ds = load_dataset("synth-tiny")
    cfg = tgcn.GCNConfig(ds.in_feats, 16, ds.n_classes, dropout=0.0)
    tc = TTC(n_epochs=8, num_subnet=2, iter_per_site=4, split_input=True)
    init = _np_tree(jgcn.init(jax.random.PRNGKey(0), jgcn.GCNConfig(
        ds.in_feats, 16, ds.n_classes)))
    sizes = JPart.boundary_sizes(ds.in_feats, 16, 1, split_input=True,
                                 split_output=False)
    out = {}
    for fused in (False, True):
        _inject(monkeypatch, _jax_boundaries(0, sizes, 2, 2))
        out[fused] = TSim.train_ist_simulation(
            load_dataset("synth-tiny"), cfg, tc, fused=fused,
            init_params=init, device="cpu", verbose=False)
    loop = np.asarray(out[False]["losses"]).reshape(2, 4).mean(axis=1)
    np.testing.assert_allclose(loop, out[True]["losses"], rtol=1e-6)
    assert out[True]["val_accs"] == [out[False]["val_accs"][i]
                                     for i in (3, 7)]


def test_simulation_lr_schedule_and_virtual_units(monkeypatch):
    """A hidden width that K does not divide trains (VIRTUAL_IDX units
    read zero and are dropped at merge), and each round's fresh Adam
    takes the 50%/75% decayed learning rate of its first epoch."""
    ds = load_dataset("synth-tiny")
    cfg = tgcn.GCNConfig(ds.in_feats, 10, ds.n_classes, n_layers=2,
                         dropout=0.0)
    tc = TTC(n_epochs=8, num_subnet=3, iter_per_site=2)
    lrs = []
    real = TSim.make_optimizer

    def spy(leaves, lr, wd):
        lrs.append(lr)
        return real(leaves, lr, wd)
    monkeypatch.setattr(TSim, "make_optimizer", spy)
    r = TSim.train_ist_simulation(ds, cfg, tc, device="cpu", verbose=False)
    assert lrs == [1e-2, 1e-2, 1e-3, 1e-4]
    assert len(r["losses"]) == 8 and np.isfinite(r["losses"]).all()
    assert r["mean_epoch_s"] > 0 and r["kteps"] > 0


def test_train_ist_cli_matches_jax(monkeypatch):
    """``cli.train_ist`` on synth-tiny with self loops, the random
    projection and split input against the JAX CLI, the port given the
    JAX CLI's initial parameters and boundaries (seed 3)."""
    from gist_tpu.cli import train_ist as jcli

    from gist_tpu_torch.cli import train_ist as tcli
    argv = ["--dataset", "synth-tiny", "--n-epochs", "6", "--n-hidden", "16",
            "--num_subnet", "2", "--iter_per_site", "3", "--dropout", "0"]
    for fused in ([], ["--fused"]):
        want = jcli.main(argv + fused)
        ds = load_dataset("synth-tiny", self_loop=True)
        f = (ds.in_feats // 2) * 2
        jcfg = jgcn.GCNConfig(f, 16, ds.n_classes, dropout=0.0)
        init = _np_tree(jgcn.init(jax.random.PRNGKey(3), jcfg))
        monkeypatch.setattr(
            tgcn, "init", lambda gen, cfg: {"layers": [
                {k: torch.tensor(v, device=gen.device) for k, v in l.items()}
                for l in init["layers"]]})
        sizes = JPart.boundary_sizes(f, 16, 1, split_input=True,
                                     split_output=False)
        _inject(monkeypatch, _jax_boundaries(3, sizes, 2, 2))
        got = tcli.main(argv + fused + ["--device", "cpu"])
        _hold(want, got, ds)
