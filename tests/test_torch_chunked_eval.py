"""The port's chunked host eval (``sage.apply_chunked_host``) against
the JAX package's on the same numpy params, under both eval backends
(``GIST_EVAL_BACKEND=numpy`` and ``=torch``), against the port's own
fp32 ``sage.apply``, and inside the ultra-wide trainer, whose chunked
branch is taken with the threshold constant lowered."""

import jax
import numpy as np
import pytest
import torch

from gist_tpu.models import sage as jsage

from gist_tpu_torch.convert import params_from_jax
from gist_tpu_torch.data import load_dataset
from gist_tpu_torch.graph import graph_from_edges
from gist_tpu_torch.models import sage as tsage
from gist_tpu_torch.train import ist_ultrawide as TUW
from gist_tpu_torch.train.common import TrainConfig


@pytest.fixture(scope="module")
def case():
    ds = load_dataset("synth-tiny")
    args = (ds.in_feats, 48, ds.n_classes)
    jcfg = jsage.SAGEConfig(*args, n_layers=3)
    tcfg = tsage.SAGEConfig(*args, n_layers=3)
    params = jax.tree.map(np.asarray, jsage.init(jax.random.PRNGKey(0), jcfg))
    return ds, jcfg, tcfg, params


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("node_chunk", [50, 131_072])
def test_matches_jax(case, backend, node_chunk, monkeypatch):
    ds, jcfg, tcfg, params = case
    monkeypatch.setenv("GIST_EVAL_BACKEND", backend)
    want = jsage.apply_chunked_host(params, ds.senders, ds.receivers,
                                    ds.features, jcfg, node_chunk=node_chunk)
    got = tsage.apply_chunked_host(params, ds.senders, ds.receivers,
                                   ds.features, tcfg, node_chunk=node_chunk)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_backends_agree_and_match_plain_apply(case, monkeypatch):
    ds, _, tcfg, params = case
    out = {}
    for backend in ("numpy", "torch", "auto"):
        monkeypatch.setenv("GIST_EVAL_BACKEND", backend)
        out[backend] = tsage.apply_chunked_host(
            params, ds.senders, ds.receivers, ds.features, tcfg,
            node_chunk=50)
    np.testing.assert_array_equal(out["auto"], out["torch"])
    # two BLAS orders, each rounded to fp16 between layers: the JAX
    # package's bar between its two paths (tests/test_ultrawide.py)
    np.testing.assert_allclose(out["torch"], out["numpy"], rtol=2e-2,
                               atol=2e-2)
    assert (out["torch"].argmax(-1) == out["numpy"].argmax(-1)).mean() > 0.99
    g = graph_from_edges(ds.senders, ds.receivers, ds.n_nodes)
    with torch.no_grad():
        plain = tsage.apply(params_from_jax(params), g,
                            torch.from_numpy(ds.features), tcfg).numpy()
    # fp16 storage of the activations: values to 0.05, argmax nearly all
    np.testing.assert_allclose(out["torch"], plain, rtol=0.05, atol=0.05)
    assert (out["torch"].argmax(-1) == plain.argmax(-1)).mean() > 0.98
    monkeypatch.setenv("GIST_EVAL_BACKEND", "jax")
    with pytest.raises(ValueError, match="GIST_EVAL_BACKEND"):
        tsage.apply_chunked_host(params, ds.senders, ds.receivers,
                                 ds.features, tcfg)


def test_trainer_chunked_branch(monkeypatch):
    """The same training with the eval through the chunked forward (the
    threshold lowered to 0) and through the plain one: val accuracy
    within one validation node, the chunked forward called once per
    eval."""
    calls = []
    real = tsage.apply_chunked_host
    monkeypatch.setattr(tsage, "apply_chunked_host",
                        lambda *a, **k: calls.append(1) or real(*a, **k))

    def run():
        ds = load_dataset("synth-tiny")
        cfg = tsage.SAGEConfig(ds.in_feats, 32, ds.n_classes, n_layers=2,
                               dropout=0.2)
        tc = TrainConfig(lr=1e-2, weight_decay=0.0, n_epochs=8,
                         num_subnet=2, iter_per_site=2)
        return TUW.train_ist_ultrawide(ds, cfg, tc, psize=4, batch_size=2,
                                       verbose=False, device="cpu")

    plain = run()
    assert not calls
    monkeypatch.setattr(TUW, "CHUNKED_EVAL_MIN_ELEMENTS", 0)
    chunked = run()
    assert len(calls) == len(chunked["val_accs"]) == 4
    assert chunked["losses"] == plain["losses"]
    n_val = int(load_dataset("synth-tiny").val_mask.sum())
    np.testing.assert_allclose(chunked["val_accs"], plain["val_accs"],
                               atol=1.0 / n_val + 1e-9)
