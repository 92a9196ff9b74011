"""The port's single-card benchmark scripts (``gist_tpu_torch/bench/``:
``spmm``, ``gat``, ``kernel_tune``, ``sharded``) on the CPU at small
sizes, with the JAX scripts' keys; K1's plain walk at the tile sizes
those scripts build (TN 64 and 256) against the JAX ``_dedup_kernel``
in interpret mode; and the single-card graft entry against the JAX
one."""

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gist_tpu.graph as JG
from gist_tpu.ops import pallas_spmm

import gist_tpu_torch.graph as TG
from gist_tpu_torch import graft_entry
from gist_tpu_torch.bench import gat, kernel_tune, sharded, spmm
from gist_tpu_torch.convert import params_from_jax
from gist_tpu_torch.ops import dedup_spmm as K
from torch_port_helpers import load_jax_partitioner, run_interpret

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = "synth-tiny"
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _printed(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.strip()]


def test_spmm_script(tmp_path, capsys):
    out = tmp_path / "spmm.json"
    rows = spmm.main(["--dataset", TINY, "--grad", "--iters", "2", *CPU,
                      "--out", str(out)])
    assert _printed(capsys) == rows == json.loads(out.read_text())
    keys = {"op", "backend", "dtype", "dataset", "E", "F", "ms",
            "edges_per_sec"}
    assert [(r["op"], r["backend"]) for r in rows] == [
        ("spmm_fwd", "pallas"), ("spmm_fwd_bwd", "pallas"),
        ("spmm_fwd", "segment"), ("spmm_fwd_bwd", "segment")]
    for r in rows:
        assert keys <= set(r) and r["ms"] > 0 and r["hardware"] == "cpu"


@pytest.mark.parametrize("layout", ["dedup", "gather"])
def test_gat_script_attention(tmp_path, capsys, layout):
    rows = gat.main(["--nodes", "300", "--edges", "3000", "--dim", "16",
                     "--iters", "2", "--layout", layout, *CPU,
                     "--out", str(tmp_path / "gat.json")])
    assert _printed(capsys) == rows
    lines = [r for r in rows if r.get("op") == "gat_attention"]
    assert [r["backend"] for r in lines] == [f"kernel-{layout}", "segment"]
    for r in lines:
        assert {"op", "backend", "N", "E", "D", "dtype", "ms",
                "edges_per_sec"} <= set(r)
    if layout == "dedup":
        assert {"layout", "N", "E", "unique_slots", "dedup_ratio"} == set(
            rows[0])


@pytest.mark.parametrize("layout", ["dedup", "gather"])
def test_gat_script_train_step(tmp_path, capsys, layout):
    """The three configurations (fused kernel backward, the backward
    through the segment composite, the segment backend) train the same
    model: losses within 1e-4 of each other, first-step gradients within
    1e-5 of the segment backend's (norm-relative, per leaf); the fused
    backward is set again afterwards."""
    from gist_tpu_torch.ops import gat_dedup
    rows = gat.main(["--dataset", TINY, "--dim", "16", "--iters", "3",
                     "--layout", layout, "--train-step", *CPU,
                     "--out", str(tmp_path / "gat.json")])
    steps = [r for r in rows if r.get("op") == "gat_train_step"]
    assert [r["config"] for r in steps] == [c[0] for c in gat.CONFIGS]
    for r in steps:
        assert {"op", "config", "N", "E", "D", "layers", "heads",
                "ms_per_step"} <= set(r)
        for k in ("loss_first", "loss_last"):
            assert abs(r[k] - steps[0][k]) <= 1e-4 * abs(steps[0][k])
        # the first step's gradients, against the segment backend's
        assert r["grad_norm_rel_err"] <= 1e-5
    assert steps[-1]["grad_norm_rel_err"] == 0.0
    assert gat_dedup._GAT_BACKWARD == "fused"


def test_kernel_tune_script(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(kernel_tune, "GATHER_ROWS", 4096)
    out = kernel_tune.main(["--dataset", TINY, *CPU, "--out",
                            str(tmp_path / "kt.json")])
    assert [(r["tile_rows"], r["dtype"]) for r in out["rows"]] == [
        (tn, dt) for tn in (64, 128, 256) for dt in ("fp32", "bf16")]
    for r in out["rows"]:
        assert {"tile_rows", "dtype", "d_slot", "w_mib", "ms",
                "edges_per_s_M", "bound_ms", "bound_by", "max_abs_err",
                "rel_err", "tol", "bitwise_repeat"} == set(r)
        # on the CPU the wrapper runs the plain walk itself
        assert r["max_abs_err"] == 0.0 and r["bitwise_repeat"]
    # bigger tiles share senders across more rows
    d = [r["d_slot"] for r in out["rows"][::2]]
    assert d[0] > d[1] > d[2]
    assert [g["cols"] for g in out["gather_microbench"]] == [602, 608, 640]
    for g in out["gather_microbench"]:
        assert {"cols", "ms_per_1M_rows", "GB_s", "rows_per_s_M"} == set(g)
    assert len(_printed(capsys)) == 9


def test_sharded_script(tmp_path, capsys):
    """At D=1 the sharded aggregation equals the flat one within 1e-5
    (kernel and segment rings), and so does the sharded GCN forward.
    Without a link rate the step record has no projection; with one it
    has JAX's ``projected_scaling_from_sharded_step`` from its own D=1
    time, equal to JAX's formula at that time and rate."""
    out = sharded.main(["--dataset", TINY, *CPU, "--out",
                        str(tmp_path / "sh.json")])
    step, gcn = out["step"], out["gcn"]
    assert {"dataset", "n_edges", "f", "hardware", "flat_kernel_ms",
            "flat_edges_per_sec", "sharded_vs_flat", "sharded_d1_kernel_ms",
            "sharded_d1_kernel_rel_err", "sharded_d1_segment_ms",
            "sharded_d1_segment_rel_err"} <= set(step)
    assert "projected_scaling_from_sharded_step" not in step
    assert step["sharded_d1_kernel_rel_err"] <= 1e-5
    assert step["sharded_d1_segment_rel_err"] <= 1e-5
    assert {"dataset", "n_edges", "f", "hidden", "n_layers", "hardware",
            "flat_fwd_ms", "sharded_d1_fwd_ms", "sharded_vs_flat",
            "sharded_rel_err", "edges_per_sec_flat",
            "edges_per_sec_sharded_d1"} <= set(gcn)
    assert gcn["sharded_rel_err"] <= 1e-5
    assert _printed(capsys) == [step, gcn]

    rate = 1.25e9                        # an input, not a card's figure
    linked = sharded.main(["--dataset", TINY, *CPU, "--out",
                           str(tmp_path / "sh2.json"), "--link-bytes-per-s",
                           str(rate), "--link-name", "a test link"])["step"]
    proj = linked["projected_scaling_from_sharded_step"]
    t1 = linked["sharded_d1_kernel_ms"]
    assert (proj["t1_ms"], proj["link_bytes_per_s"], proj["link_name"]) \
        == (t1, rate, "a test link")
    from gist_tpu.data import synthetic_dataset
    from gist_tpu.parallel import build_sharded_graph as j_build
    ds = synthetic_dataset(TINY)
    for d in (2, 4, 8):
        sg = j_build(ds.senders, ds.receivers, ds.n_nodes, d,
                     interior_tiles=False)
        want = sg.projected_scaling(t1_agg_s=t1 / 1e3, f=ds.in_feats,
                                    ici_bytes_per_s=rate)
        want["efficiency_overlap_bf16_halo"] = sg.projected_scaling(
            t1_agg_s=t1 / 1e3, f=ds.in_feats, halo_itemsize=2,
            ici_bytes_per_s=rate)["efficiency_overlap"]
        got = proj[f"d{d}"]
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), (d, k)
    with pytest.raises(SystemExit):
        sharded.main(["--dataset", TINY, *CPU, "--link-bytes-per-s", "1e9"])


def test_default_outputs_write_no_existing_result():
    """The port's scripts write ``results/torch_<name>.json``, never a
    file of the JAX package's records."""
    existing = {p.name for p in (ROOT / "results").iterdir()}
    outs = [m.DEFAULT_OUT for m in (spmm, gat, kernel_tune, sharded)]
    assert len(set(outs)) == len(outs)
    for path in outs:
        p = pathlib.PurePath(path)
        assert p.parent.name == "results" and p.name.startswith("torch_")
        assert p.name not in existing, path


@pytest.mark.parametrize("tn", [64, 256])
def test_k1_plain_walk_at_tile_size_matches_pallas(tn):
    """K1's plain walk on a TN-row layout equals the JAX
    ``_dedup_kernel`` (interpret mode) on the same layout, 1e-5
    relative to the max; the layouts are array-equal."""
    rng = np.random.default_rng(tn)
    n = 3000
    s, r = rng.integers(0, n, 20000), rng.integers(0, n, 20000)
    dj = JG._build_dedup_tiles(s, r, n, tile_rows=tn, reorder=False)
    dt = TG._build_dedup_tiles(s, r, n, tile_rows=tn, reorder=False)
    for k in ("u_senders", "w_blocks", "job_offsets"):
        np.testing.assert_array_equal(np.asarray(getattr(dj, k)),
                                      getattr(dt, k).numpy())
    assert dt.tile_rows == tn
    if tn == 256:
        assert dt.max_jobs > 1      # tiles of several jobs
    gj = JG.graph_from_edges(s, r, n).replace(dedup=dj)
    x = rng.standard_normal((n, 24)).astype(np.float32)
    want = run_interpret(lambda: pallas_spmm.spmm_pallas_csr(
        gj, jnp.asarray(x)))
    out = K.dedup_spmm(dt.job_offsets, dt.w_blocks, dt.u_senders,
                       torch.from_numpy(x))
    assert out.shape == (dt.num_tiles * tn, 24)
    got = K.run_dedup(dt, torch.from_numpy(x), n).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


def test_graft_entry_matches_jax():
    """``graft_entry.entry("cpu")``'s forward equals the JAX
    ``__graft_entry__.entry()`` forward with the same params, 1e-5."""
    sys.path.insert(0, str(ROOT))
    import __graft_entry__
    jfn, (jparams, jx) = __graft_entry__.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jx))
    fn, (params, x) = graft_entry.entry("cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    assert set(params) == {"layers"} and len(params["layers"]) == 3
    with torch.no_grad():
        got = fn(params_from_jax(jax.tree.map(np.asarray, jparams)), x)
    assert got.shape == want.shape == (x.shape[0], 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_graft_entry_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
