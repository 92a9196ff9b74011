"""The port's benchmark entry (``gist_tpu_torch/bench/entry.py``,
``bench_torch.py``) on the CPU: its one JSON line in the JAX bench's CPU
mode and with every section on the plain walks, its failure line, and
its sections against the JAX package on the same seeded inputs (the
headline SpMM and the GAT attention against the Pallas kernels in
interpret mode, the SAGE train step against an optax loop)."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gist_tpu.graph as JG
from gist_tpu.data import synthetic_dataset as jax_dataset
from gist_tpu.models import sage as jsage
from gist_tpu.models.common import masked_cross_entropy as jax_ce
from gist_tpu.ops import pallas_spmm
from gist_tpu.ops.pallas_gat import gat_attention_dedup as jax_gat_dedup

import gist_tpu_torch.graph as TG
from gist_tpu_torch.bench import entry
from gist_tpu_torch.convert import params_from_jax
from gist_tpu_torch.data import synthetic_dataset
from gist_tpu_torch.ops.dedup_spmm import spmm_dedup
from gist_tpu_torch.ops.gat_dedup import gat_attention_dedup
from torch_port_helpers import load_jax_partitioner, run_interpret

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the keys of a full run of the JAX bench (bench.py:276-287 and the
# sections' extras), its TPU-only key, and what the port adds
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "fp32_ms", "n_edges",
            "hardware", "bf16_edges_per_sec", "bf16_ms",
            "fp32_ms_graph_as_arg", "segment_ms", "train_step_ms",
            "train_step_ms_segment", "gat_dedup_ms",
            "gat_dedup_edges_per_sec", "gat_segment_ms",
            "gat_dedup_speedup", "chunked_small_ms",
            "chunked_small_edges_per_sec", "chunked_small_n_chunks"}
TPU_ONLY = {"fp32_ms_graph_as_arg"}
PORT_ADDED = {"fp32_bound_ms", "fp32_bound_share", "fp32_call_ms",
              "power_limit_w", "kernel_launches"}
TINY = "synth-tiny"


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.strip()]


def test_bench_fast_prints_one_json_line(monkeypatch, capsys):
    """``GIST_BENCH_FAST=1`` (``tests/test_bench_entry.py:11``): the CPU,
    the segment section alone, one line."""
    monkeypatch.setenv("GIST_BENCH_FAST", "1")
    assert entry.main([]) == 0
    lines = _lines(capsys)
    assert len(lines) == 1
    rec = lines[0]
    assert {"metric", "value", "unit", "vs_baseline"} <= set(rec)
    assert rec["value"] > 0
    assert rec["hardware"] == "cpu" and rec["fp32_ms"] == rec["segment_ms"]
    assert rec["n_edges"] == len(synthetic_dataset(entry.DATASET).senders)


def test_bench_cpu_runs_every_section(monkeypatch, capsys, tmp_path):
    monkeypatch.delenv("GIST_BENCH_FAST", raising=False)
    argv = ["--device", "cpu", "--dataset", TINY, "--cache-dir",
            str(tmp_path)]
    assert entry.main(argv) == 0
    (rec,) = _lines(capsys)
    assert set(entry.JAX_KEYS) == JAX_KEYS
    assert set(entry.NOT_CARRIED) == TPU_ONLY
    assert set(entry.PORT_KEYS) == PORT_ADDED
    assert set(rec) == (JAX_KEYS - TPU_ONLY) | PORT_ADDED
    assert rec["hardware"] == "cpu" and rec["power_limit_w"] is None
    assert rec["kernel_launches"] == {}       # the plain walks launch none
    for k, v in rec.items():
        if isinstance(v, float):
            assert np.isfinite(v) and v > 0, k
    assert 0 < rec["fp32_bound_share"] < 1
    assert "K1 plain walk" in rec["metric"]
    # the chunked layout is cached under its own name and read back
    ds = synthetic_dataset(TINY)
    cache = pathlib.Path(entry.chunked_cache_path(ds, TINY, str(tmp_path)))
    assert cache.exists() and cache.name.startswith(
        f"torch_bench_chunked_{TINY}_tn64_c8192_")
    # another graph is cached under another name
    other = dataclasses.replace(ds, receivers=ds.receivers[::-1].copy())
    assert entry.chunked_cache_path(other, TINY, str(tmp_path)) != str(cache)
    a = entry.chunked_layout(ds, TINY, str(tmp_path))
    b = TG._build_dedup_chunked(ds.senders, ds.receivers, ds.n_nodes,
                                tile_rows=64, chunk_rows=2 ** 13)
    for k in ("u_senders", "w_blocks", "job_offsets", "pos", "perm"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert (a.tile_rows, a.max_jobs, a.num_tiles, a.n_chunks) == (
        b.tile_rows, b.max_jobs, b.num_tiles, rec["chunked_small_n_chunks"])


def test_bench_section_failure_is_one_error_line(monkeypatch, capsys,
                                                 tmp_path):
    def broken(g, x):
        raise RuntimeError("section failed")

    monkeypatch.delenv("GIST_BENCH_FAST", raising=False)
    monkeypatch.setattr(entry, "gat_section", broken)
    rc = entry.main(["--device", "cpu", "--dataset", TINY, "--cache-dir",
                     str(tmp_path)])
    lines = _lines(capsys)
    assert rc == 1 and len(lines) == 1
    assert lines[0]["value"] == 0.0
    assert "section failed" in lines[0]["error"]
    assert not set(lines[0]) & {"fp32_ms", "gat_dedup_ms"}


def test_bench_without_card_or_cpu_request_fails():
    """Without a card and without ``--device cpu`` or
    ``GIST_BENCH_FAST=1``: one error line and exit code 1, through the
    root shim, run from the checkout's root."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry would run on it")
    env = {k: v for k, v in os.environ.items() if k != "GIST_BENCH_FAST"}
    res = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.strip()]
    assert res.returncode == 1 and len(lines) == 1
    assert "no CUDA device" in lines[0]["error"]


def _graphs(ds):
    """synth-tiny with its layouts in both packages."""
    gj = JG.graph_from_edges(ds.senders, ds.receivers, ds.n_nodes,
                             tiles=True)
    gt = TG.graph_from_edges(ds.senders, ds.receivers, ds.n_nodes,
                             tiles=True)
    assert gt.dedup is not None
    np.testing.assert_array_equal(np.asarray(gj.dedup.w_blocks),
                                  gt.dedup.w_blocks.numpy())
    return gj, gt


def test_headline_spmm_matches_jax():
    """The headline's K1 aggregation (plain walk) against
    ``spmm_pallas_csr`` on the forward layout, 1e-5 relative to the
    max."""
    ds = synthetic_dataset(TINY)
    gj, gt = _graphs(ds)
    x = ds.features
    want = run_interpret(lambda: pallas_spmm.spmm_pallas_csr(
        gj.replace(dedup_t=None, tiled_t=None), jnp.asarray(x)))
    got = spmm_dedup(entry.forward_only(gt), torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


def test_gat_section_matches_jax():
    """The GAT section's attention (K4's plain walk, the section's
    inputs) against the JAX dedup attention, 4e-3 (the GAT kernels'
    bar, ``pallas_gat.py:15-18``)."""
    ds = synthetic_dataset(TINY)
    gj, gt = _graphs(ds)
    z, av, bv = entry.gat_inputs(torch.from_numpy(ds.features), ds.n_nodes)
    assert z.is_contiguous() and z.shape[1] == min(ds.in_feats, 128)
    want = run_interpret(lambda: jax_gat_dedup(
        gj, jnp.asarray(z.numpy()), jnp.asarray(av.numpy()),
        jnp.asarray(bv.numpy()), 0.01))
    with torch.no_grad():
        got = gat_attention_dedup(gt, z, av, bv, 0.01).numpy()
    np.testing.assert_allclose(got, want, rtol=4e-3, atol=4e-3)


@pytest.mark.parametrize("backend", ["dedup", "segment"])
def test_sage_train_step_matches_optax(backend):
    """Three steps of the bench's SAGE train step from the JAX init,
    against ``optax.adam(1e-2)`` on the JAX model (segment path), losses
    within 1e-5."""
    ds = synthetic_dataset(TINY)
    jds = jax_dataset(TINY)
    gt = TG.graph_from_edges(ds.senders, ds.receivers, ds.n_nodes,
                             tiles=True)
    gj = JG.graph_from_edges(jds.senders, jds.receivers, jds.n_nodes)
    cfg = entry.sage_config(ds)
    jcfg = jsage.SAGEConfig(jds.in_feats, 256, jds.n_classes, n_layers=2,
                            dropout=0.0)
    params = jsage.init(jax.random.PRNGKey(0), jcfg)
    x, labels = jnp.asarray(jds.features), jnp.asarray(jds.labels)
    mask = jnp.asarray(jds.train_mask)
    opt = optax.adam(1e-2)

    @jax.jit
    def jstep(p, s):
        loss, grads = jax.value_and_grad(lambda q: jax_ce(
            jsage.apply(q, gj, x, jcfg), labels, mask))(p)
        upd, s = opt.update(grads, s)
        return optax.apply_updates(p, upd), s, loss

    want, p, s = [], params, opt.init(params)
    for _ in range(3):
        p, s, loss = jstep(p, s)
        want.append(float(loss))

    step = entry.sage_step(params_from_jax(jax.tree.map(np.asarray, params)),
                           gt, torch.from_numpy(ds.features),
                           torch.from_numpy(ds.labels),
                           torch.from_numpy(ds.train_mask), cfg, backend)
    got = [float(step()) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
