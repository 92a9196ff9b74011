"""K7's, K8's and K9's launch plans, chosen on the host from D and the
alignment (``gist_tpu_torch.ops.gat_tiled.fwd_plan``, ``b1_plan`` and
``b2_plan``), and the plan launches' refusal of CPU tensors.  CPU only: the kernels
themselves are held against their plain walks on the card
(``tests/test_torch_cuda.py``)."""

import os
import re

import numpy as np
import pytest
import torch

from gist_tpu_torch.graph import graph_from_edges
from gist_tpu_torch.ops import gat_tiled as GT

WIDTHS = [1, 2, 7, 16, 37, 41, 47, 63, 64, 65, 100, 128, 129, 130, 256, 257,
          512, 602, 1024]


def _source():
    with open(GT.SOURCE, encoding="utf-8") as fh:
        return fh.read()


def _covers(plan, d, most):
    """The plan is an instance (a group of 8 or 16 lanes, a per-lane count
    the kernel has, at most ``most`` values a lane) and its block columns
    or chunks cover D, the last one holding some of it."""
    assert plan.group in GT.GROUPS and plan.per_lane in GT.PER_LANE
    assert plan.per_lane * plan.vec <= most
    spans = -(-d // plan.span)
    assert spans * plan.span >= d > (spans - 1) * plan.span
    return spans


def _group_rule(plan, d, most):
    """Groups of 8 lanes exactly where 8 lanes can hold the row (within
    ``most`` values a lane, in one block column or chunk)."""
    nv = -(-d // plan.vec)
    fits8 = any(c * plan.vec <= most and 8 * c >= nv for c in GT.PER_LANE)
    assert plan.group == (8 if fits8 else 16)


@pytest.mark.parametrize("vec", [1, 2, 4])
@pytest.mark.parametrize("d", WIDTHS)
def test_fwd_plan_covers_every_column_with_an_instance(d, vec):
    """K7: one warp per row, groups of 8 lanes where 8 lanes hold the row
    within FWD_MAX accumulators, else 16, the fewest vectors a lane that
    cover the row in one block column, else as many as a lane may hold
    in each of several."""
    plan = GT.fwd_plan(d, vec)
    assert plan.vec == vec and not plan.rows
    _group_rule(plan, d, GT.FWD_MAX)
    cols = _covers(plan, d, GT.FWD_MAX)
    assert plan.grid(23040, d) == (2880, cols)
    if cols == 1:   # no instance with fewer vectors covers the row
        assert all(c * plan.group * vec < d for c in GT.PER_LANE
                   if c < plan.per_lane)
    else:
        assert plan.per_lane == max(c for c in GT.PER_LANE
                                    if c * vec <= GT.FWD_MAX)


@pytest.mark.parametrize("vec", [1, 2, 4])
@pytest.mark.parametrize("d", WIDTHS)
def test_b1_plan_covers_every_column_with_an_instance(d, vec):
    """K8: a row per group, G_r's columns of the row in the lanes'
    registers, at most B1_MAX values a lane; a wider row is walked once
    per chunk of ``span`` columns, each chunk as wide as a lane may
    hold."""
    plan = GT.b1_plan(d, vec)
    assert plan.vec == vec and plan.rows
    _group_rule(plan, d, GT.B1_MAX)
    chunks = _covers(plan, d, GT.B1_MAX)
    if chunks > 1:
        assert plan.per_lane == max(c for c in GT.PER_LANE
                                    if c * vec <= GT.B1_MAX)


@pytest.mark.parametrize("vec", [1, 2, 4])
@pytest.mark.parametrize("d", WIDTHS)
def test_b2_plan_covers_every_column_with_an_instance(d, vec):
    """K9: a row per group; 16 lanes holding the row in one block column
    with the fewest vectors a lane that cover it, where 16 lanes can
    within B2_MAX accumulators, else 8 lanes with as many vectors as a
    lane may hold, a block column per span."""
    plan = GT.b2_plan(d, vec)
    assert plan.vec == vec and plan.rows
    cols = _covers(plan, d, GT.B2_MAX)
    assert plan.grid(23040, d) == (-(-23040 // (8 * 32 // plan.group)),
                                   cols)
    most = max(c for c in GT.PER_LANE if c * vec <= GT.B2_MAX)
    assert plan.group == (16 if 16 * most * vec >= d else 8)
    if plan.group == 16:
        assert cols == 1
        assert all(c * 16 * vec < d for c in GT.PER_LANE
                   if c < plan.per_lane)
    else:
        assert plan.per_lane == most


@pytest.mark.parametrize("d,vec,want", [
    # D=41 (the output layer): 16 lanes x 3 values, two rows a warp
    (41, 1, (True, 16, 3, 1, 1)),
    # D=512 fp32 and bf16 (float4 and 4 x bf16 loads): 8 lanes x 4
    # vectors, four rows a warp, four block columns of 128
    (512, 4, (True, 8, 4, 4, 4)),
    (1024, 4, (True, 8, 4, 4, 8)),
    (602, 2, (True, 8, 8, 2, 5)),
    (256, 4, (True, 16, 4, 4, 1)),
])
def test_b2_plan_at_the_paths_widths(d, vec, want):
    plan = GT.b2_plan(d, vec)
    assert (plan.rows, plan.group, plan.per_lane, plan.vec,
            -(-d // plan.span)) == want


@pytest.mark.parametrize("d,vec", [(41, 1), (47, 1), (130, 2), (512, 4),
                                   (1024, 4)])
def test_b2_plan_space_holds_the_chosen_plan(d, vec):
    """K9's plans a measurement compares, with the host's choice among
    them; at D=512 they hold both caps the measurement weighed (8 and 16
    accumulators a lane: four block columns of 128 or two of 256)."""
    space = GT.plan_space(d, vec, GT.B2_MAX)
    assert len(space) == len(set(space))
    for plan in space:
        _covers(plan, d, GT.B2_MAX)
    assert {p.rows for p in space} == {False, True}
    assert {p.group for p in space} == set(GT.GROUPS)
    assert GT.b2_plan(d, vec) in space
    if d == 512:
        assert {-(-d // p.span) for p in space
                if p.group == 16 and not p.rows} >= {2, 4}


@pytest.mark.parametrize("d,vec,fwd,b1", [
    # D=41 (the output layer): 41 of 48 lane slots in groups of 8; K7 one
    # warp per row (four slots a warp step), K8 four rows a warp
    (41, 1, (False, 8, 6, 1, 1), (True, 8, 6, 1, 1)),
    # D=512 fp32 and bf16 (float4 and 4 x bf16 loads), 16-lane groups: K7
    # one warp per row over four block columns of 128, K8 a row per group
    # over two chunks of 256
    (512, 4, (False, 16, 2, 4, 4), (True, 16, 4, 4, 2)),
    (1024, 4, (False, 16, 2, 4, 8), (True, 16, 4, 4, 4)),
    (602, 2, (False, 16, 4, 2, 5), (True, 16, 8, 2, 3)),
])
def test_plans_at_the_paths_widths(d, vec, fwd, b1):
    for plan, want in ((GT.fwd_plan(d, vec), fwd), (GT.b1_plan(d, vec), b1)):
        assert (plan.rows, plan.group, plan.per_lane, plan.vec,
                -(-d // plan.span)) == want


@pytest.mark.parametrize("d,vec", [(41, 1), (47, 1), (130, 2), (512, 4),
                                   (1024, 4)])
@pytest.mark.parametrize("most", [GT.FWD_MAX, GT.B1_MAX])
def test_plan_space_holds_the_chosen_plan(d, vec, most):
    """The plans a measurement compares: both modes and group sizes, each
    per-lane count of an instance up to the fewest that cover D, the
    host's choice among them."""
    space = GT.plan_space(d, vec, most)
    assert len(space) == len(set(space))
    for plan in space:
        _covers(plan, d, most)
    assert {p.rows for p in space} == {False, True}
    assert {p.group for p in space} == set(GT.GROUPS)
    chosen = GT.fwd_plan(d, vec) if most == GT.FWD_MAX else \
        GT.b1_plan(d, vec)
    assert chosen in space


def test_plan_constants_match_the_kernel_source():
    text = _source()
    for name, value in (("FWD_MAX", GT.FWD_MAX), ("B1_MAX", GT.B1_MAX),
                        ("B2_MAX", GT.B2_MAX)):
        found = re.search(rf"constexpr int {name} = (\d+);", text)
        assert found and int(found.group(1)) == value, name
    cases = re.findall(r"case (\d+): return with_c<MAX, (\d+)>", text)
    assert [int(a) for a, b in cases] == list(GT.PER_LANE)
    assert all(a == b for a, b in cases)
    for group in GT.GROUPS:
        assert re.search(rf"g == {group}\) return pick_c<MAX>\(c, go, v, "
                         rf"Int<{group}>", text), group
    assert os.path.basename(GT.SOURCE) == "gat_tiled.cu"


def test_plan_launches_refuse_cpu_tensors():
    """The wrappers take the plain walks for CPU tensors; the plan
    launches never do, so they raise instead of falling back, and no
    launch is counted."""
    rng = np.random.default_rng(0)
    s, r = rng.integers(0, 300, 2000), rng.integers(0, 300, 2000)
    g = graph_from_edges(s, r, 300, tiles=True, tile_mode="gather")
    t = g.tiled

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    z, src, dst, gg = randn(300, 41), randn(300), randn(300), randn(300, 41)
    before = (GT.launches_fwd, GT.launches_b1, GT.launches_b2)
    out, m, l = GT.gat_tiled_fwd(t, z, src, dst, 0.2)
    ds, ddst = GT.gat_tiled_bwd_b1(t, z, src, dst, m, l, gg, 0.2)
    dz, dsrc = GT.gat_tiled_bwd_b2(g.tiled_t, ds, gg, src, dst, m, l, 0.2)
    assert out.shape == (t.num_tiles * t.tile_rows, 41)
    assert ds.shape == t.senders.shape and ddst.shape == m.shape
    rows_t = g.tiled_t.num_tiles * g.tiled_t.tile_rows
    assert dz.shape == (rows_t, 41) and dsrc.shape == (rows_t,)
    with pytest.raises(ValueError):
        GT.run_fwd_plan(t, z, src, dst, 0.2, GT.fwd_plan(41, 1))
    with pytest.raises(ValueError):
        GT.run_fwd_plan(t, z, src, dst, 0.2, None)
    with pytest.raises(ValueError):
        GT.run_b1_plan(t, z, src, dst, m, l, gg, 0.2, GT.b1_plan(41, 1))
    for plan in (GT.b2_plan(41, 1), None):
        with pytest.raises(ValueError):
            GT.run_b2_plan(g.tiled_t, ds, gg, src, dst, m, l, 0.2, plan)
    assert (GT.launches_fwd, GT.launches_b1, GT.launches_b2) == before
