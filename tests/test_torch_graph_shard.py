"""The port's graph sharding against the JAX package: the host build of
``build_sharded_graph`` (array-equal at D = 1, 2, 4 and 8, interior
dedup layouts included), and ``sharded_aggregate`` (ring, all_to_all,
overlapped, bf16 halo, K1's plain walk on the interior layouts) and the
sharded GAT attention (K4's plain walk merged with the boundary
partials) in gloo worlds of CPU ranks against JAX's ``shard_map`` on the
8-device CPU mesh, forward and gradients.

The JAX side runs in the test process, its Pallas kernels in interpret
mode (``torch_port_helpers.run_interpret``); the port's ranks run in
torch-only children (``torch_dist_workers``), each world spawned once
for the module."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from conftest import dense_adj

from gist_tpu.parallel import build_sharded_graph as j_build
from gist_tpu.parallel import sharded_aggregate as j_agg
from gist_tpu.parallel.graph_shard import shard_features as j_shard
from gist_tpu.parallel.graph_shard import unshard as j_unshard

from gist_tpu_torch.parallel import build_sharded_graph as t_build
from torch_dist_workers import run_world
from torch_port_helpers import load_jax_partitioner, run_interpret

WORLD = 4
N, E, F = 1200, 9000, 8


@pytest.fixture(autouse=True, scope="module")
def _jax_partitioner():
    load_jax_partitioner()


def _graph(n, e, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = np.where(rng.random(e) < 0.7,
                 (s + rng.integers(-40, 40, e)) % n, rng.integers(0, n, e))
    return s, r


def _mesh(d):
    return Mesh(np.asarray(jax.devices()[:d]), ("graph",))


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                  err_msg=what)


def _tiles_eq(tj, tt, what):
    assert (tj is None) == (tt is None), what
    if tj is None:
        return
    for f in ("u_senders", "w_blocks", "job_offsets", "pos"):
        a, b = getattr(tj, f), getattr(tt, f)
        assert (a is None) == (b is None), (what, f)
        if a is not None:
            _eq(a, b.numpy(), f"{what}.{f}")
    assert (tj.tile_rows, tj.cu, tj.max_jobs) == (tt.tile_rows, tt.cu,
                                                  tt.max_jobs), what


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_build_sharded_graph_matches_jax(d):
    s, r = _graph(2400, 20000, d)
    gj = j_build(s, r, 2400, d, interior_tiles=True)
    gt = t_build(s, r, 2400, d, interior_tiles=True)
    for f in ("senders", "receivers", "send_idx", "in_degrees",
              "out_degrees", "node_perm", "int_senders", "int_receivers",
              "bnd_senders", "bnd_receivers", "ring_bnd_senders",
              "row_valid"):
        _eq(getattr(gj, f), getattr(gt, f).numpy(), f)
    assert len(gj.ring_send_idx) == len(gt.ring_send_idx)
    for a, b in zip(gj.ring_send_idx, gt.ring_send_idx):
        _eq(a, b.numpy(), "ring_send_idx")
    for f in ("n_nodes", "n_devices", "n_loc_pad", "halo_pad", "n_edges",
              "ideal_halo_rows", "ring_shifts", "total_rows", "ring_pads"):
        assert getattr(gj, f) == getattr(gt, f), f
    assert gt.int_dedup is not None
    _tiles_eq(gj.int_dedup, gt.int_dedup, "int_dedup")
    _tiles_eq(gj.int_dedup_t, gt.int_dedup_t, "int_dedup_t")
    assert gj.comm_stats(f=64) == gt.comm_stats(f=64)
    assert gj.comm_stats(f=602, itemsize=2) == gt.comm_stats(f=602,
                                                             itemsize=2)
    pj = gj.projected_scaling(t1_agg_s=1e-2, f=602, halo_itemsize=2)
    pt = gt.projected_scaling(t1_agg_s=1e-2, f=602, halo_itemsize=2)
    assert pj.keys() == pt.keys()
    for k in pj:
        assert pj[k] == pytest.approx(pt[k], rel=1e-12), k


def test_build_without_tiles_and_explicit_parts():
    s, r = _graph(300, 2000, 9)
    parts = [np.arange(i, 300, 3) for i in range(3)]
    gj = j_build(s, r, 300, 3, parts=parts, interior_tiles=False)
    gt = t_build(s, r, 300, 3, parts=parts, interior_tiles=False)
    assert gt.int_dedup is None and gt.int_dedup_t is None
    _eq(gj.node_perm, gt.node_perm.numpy(), "node_perm")
    _eq(gj.ring_bnd_senders, gt.ring_bnd_senders.numpy(), "ring_bnd")
    assert gj.ring_shifts == gt.ring_shifts


def test_a_bailed_interior_build_raises_on_the_card():
    """A graph asked for its interior layouts whose build bailed (here a
    shard with no interior edge) raises before any array reaches a card,
    instead of aggregating there without K1; built with
    ``interior_tiles=False`` it carries no request."""
    from gist_tpu_torch.parallel.graph_shard import ring_device_arrays
    s = np.array([0, 1, 2, 3], dtype=np.int64)
    r = np.array([2, 3, 0, 1], dtype=np.int64)
    parts = [np.array([0, 1]), np.array([2, 3])]
    sg = t_build(s, r, 4, 2, parts=parts, interior_tiles=True)
    assert sg.int_dedup is None and sg.tiles_requested
    with pytest.raises(RuntimeError, match="bailed"):
        ring_device_arrays(sg, 0, "cuda")
    ring_device_arrays(sg, 0, "cpu")
    off = t_build(s, r, 4, 2, parts=parts, interior_tiles=False)
    assert not off.tiles_requested


# ---------------------------------------------------------------------------
# aggregation in a gloo world
# ---------------------------------------------------------------------------

CASES = {
    "ring": dict(variant="ring", tiles=False),
    "ring_tiles": dict(variant="ring", tiles=True),
    "a2a_overlapped": dict(variant="a2a_ov", tiles=False),
    "a2a": dict(variant="a2a", tiles=False),
    "ring_bf16_halo": dict(variant="ring", tiles=False,
                           halo_dtype="bfloat16"),
}


def _inputs():
    s, r = _graph(N, E, 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, F)).astype(np.float32)
    w = rng.standard_normal((N, F)).astype(np.float32)
    return s, r, x, w


def _gat_inputs():
    s, r = _graph(N, E, 2)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((N, 2, 16)).astype(np.float32)
    src, dst = (rng.standard_normal((N, 2)).astype(np.float32)
                for _ in range(2))
    w = rng.standard_normal((N, 2, 16)).astype(np.float32)
    return dict(s=s, r=r, n=N, z=z, src=src, dst=dst, w=w)


@pytest.fixture(scope="module")
def port():
    s, r, x, w = _inputs()
    payload = {"g": dict(s=s, r=r, n=N, x=x, w=w), "gat": _gat_inputs()}
    cases = [(k, dict(fn="aggregate", graph="g", **v))
             for k, v in CASES.items()]
    cases.append(("gat", dict(fn="gat_hybrid")))
    return run_world(WORLD, cases, payload)


def _jax_aggregate(case):
    s, r, x, w = _inputs()
    sg = j_build(s, r, N, WORLD, interior_tiles=case["tiles"])
    mesh = _mesh(WORLD)
    ring, ov = {"ring": (True, True), "a2a_ov": (False, True),
                "a2a": (False, False)}[case["variant"]]
    hdt = jnp.bfloat16 if case.get("halo_dtype") else None
    agg = j_agg(sg, mesh, overlapped=ov, ring=ring, halo_dtype=hdt)
    xs = j_shard(sg, x, mesh)
    ws = j_shard(sg, w, mesh)

    def fn():
        return (j_unshard(sg, agg(xs)),
                j_unshard(sg, jax.grad(lambda v: jnp.sum(agg(v) * ws))(xs)))
    if case["tiles"]:
        return run_interpret(fn)
    return jax.tree.map(np.asarray, fn())


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_aggregate_matches_jax(port, name):
    y_j, dx_j = _jax_aggregate(CASES[name])
    for rank, (y, dx) in enumerate(port[name]):
        scale = np.abs(y_j).max()
        np.testing.assert_allclose(y, y_j, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(dx, dx_j, rtol=1e-5,
                                   atol=1e-5 * np.abs(dx_j).max(),
                                   err_msg=f"rank {rank}")
    if "bf16" not in name:
        s, r, x, w = _inputs()
        A = dense_adj(s, r, N)
        np.testing.assert_allclose(port[name][0][0], A @ x, rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(port[name][0][1], A.T @ w, rtol=1e-5,
                                   atol=1e-4)


def test_bf16_halo_rounds_only_the_wire(port):
    """Rows that crossed ranks are bf16-rounded, interior ones exact."""
    s, r, x, w = _inputs()
    sg = t_build(s, r, N, WORLD, interior_tiles=False)
    owner = sg.node_perm.numpy() // sg.n_loc_pad
    xr = torch.from_numpy(x).bfloat16().float().numpy()
    want = np.zeros_like(x)
    np.add.at(want, r, np.where((owner[s] != owner[r])[:, None], xr[s],
                                x[s]))
    for y, _ in port["ring_bf16_halo"]:
        np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)


def _jax_gat(tiles):
    from gist_tpu.parallel.layers import sharded_gat_attention
    from gist_tpu.parallel.train import device_arrays
    d = _gat_inputs()
    sg = j_build(d["s"], d["r"], N, WORLD, interior_tiles=tiles)
    mesh = _mesh(WORLD)
    dev = device_arrays(sg)
    sh = {k: j_shard(sg, d[k].reshape(N, -1), mesh)
          for k in ("z", "src", "dst", "w")}

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P("graph"),) * 4, out_specs=P("graph"),
             check_vma=False)
    def att(z, src, dst, dv):
        dv = jax.tree.map(lambda a: a[0], dv)
        return sharded_gat_attention(sg, z.reshape(-1, 2, 16), src, dst,
                                     dv).reshape(z.shape[0], -1)

    def loss(z, src, dst):
        return jnp.sum(att(z, src, dst, dev) * sh["w"])

    def fn():
        out = att(sh["z"], sh["src"], sh["dst"], dev)
        grads = jax.grad(loss, argnums=(0, 1, 2))(sh["z"], sh["src"],
                                                 sh["dst"])
        return [j_unshard(sg, t) for t in (out,) + grads]
    res = run_interpret(fn) if tiles else jax.tree.map(np.asarray, fn())
    return [a.reshape(b.shape) for a, b in zip(
        res, (d["z"], d["z"], d["src"], d["dst"]))]


@pytest.mark.parametrize("path", ["tiles", "segment"])
def test_sharded_gat_attention_matches_jax(port, path):
    """The hybrid (K4's plain walk on interior layouts whose ``pos`` is
    not the identity, merged with the boundary partials) at the GAT
    kernels' 4e-3; the segment path at 1e-5."""
    want = _jax_gat(path == "tiles")
    tol = 4e-3 if path == "tiles" else 1e-5
    for rank, res in enumerate(port["gat"]):
        for name, got, ref in zip(("out", "dz", "dsrc", "ddst"),
                                  res[path], want):
            np.testing.assert_allclose(
                got, ref, rtol=tol, atol=tol * np.abs(ref).max(),
                err_msg=f"{path} {name} rank {rank}")
