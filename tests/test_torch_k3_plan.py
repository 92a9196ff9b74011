"""K3's launch plan, chosen on the host from F and the alignment
(``gist_tpu_torch.ops.tiled_spmm.launch_plan``), and the wrapper's
refusal to run a CUDA launch on a CPU tensor.  CPU only: the kernel
itself is held against its plain walk on the card
(``tests/test_torch_cuda.py``)."""

import os
import re

import numpy as np
import pytest
import torch

from gist_tpu_torch.graph import graph_from_edges
from gist_tpu_torch.ops import tiled_spmm as K3

WIDTHS = [1, 2, 7, 16, 37, 41, 47, 63, 64, 65, 100, 128, 129, 256, 257, 512,
          602]


@pytest.mark.parametrize("vec", [1, 2, 4])
@pytest.mark.parametrize("f", WIDTHS)
def test_plan_covers_every_column_with_an_instance(f, vec):
    """The plan's block columns cover F with an instance of the kernel (a
    group of 8 or 16 lanes, at most MAX_ACC accumulators a lane, the
    fewest vectors a lane that cover the row); one block column runs in
    edges mode, several in rows mode."""
    plan = K3.launch_plan(f, vec)
    assert plan.vec == vec and plan.group in K3.GROUPS
    assert plan.group == (16 if -(-f // vec) > 8 else 8)
    assert 1 <= plan.per_lane and plan.per_lane * vec <= K3.MAX_ACC
    cols = plan.grid(23040, f)[1]
    assert cols * plan.span >= f > (cols - 1) * plan.span
    assert plan.rows == (cols > 1)
    if cols == 1 and plan.per_lane > 1:   # no vector a lane to spare
        assert (plan.per_lane - 1) * plan.group * vec < f


@pytest.mark.parametrize("f,vec,want", [
    (41, 1, (False, 16, 3, 1)),     # 41 of 48 lane slots, 2 rows a step
    (47, 1, (False, 16, 3, 1)),
    (256, 4, (True, 16, 2, 2)),     # two rows a warp, two block columns
    (64, 4, (False, 16, 1, 1)),
    (602, 2, (True, 16, 4, 5)),
    (7, 1, (False, 8, 1, 1)),
])
def test_plan_at_the_paths_widths(f, vec, want):
    plan = K3.launch_plan(f, vec)
    assert (plan.rows, plan.group, plan.per_lane,
            plan.grid(23040, f)[1]) == want


def test_grid_counts_rows_per_block():
    """Eight warps a block: one row a warp in edges mode, 32 / group rows
    a warp in rows mode."""
    assert K3.Plan(False, 8, 6, 1).grid(23040, 41) == (2880, 1)
    assert K3.Plan(True, 8, 6, 1).grid(23040, 41) == (720, 1)
    assert K3.Plan(True, 16, 3, 1).grid(23041, 41) == (1441, 1)


@pytest.mark.parametrize("f,item,ptrs,want", [
    (256, 4, (0, 1024), 4),
    (41, 4, (0, 1024), 1),
    (602, 4, (0, 1024), 2),
    (256, 4, (8, 1024), 2),      # x 8 bytes past a 16-byte line
    (256, 2, (8, 1024), 4),      # bf16: 4 elements are 8 bytes
    (256, 4, (4, 0), 1),
])
def test_vec_width(f, item, ptrs, want):
    assert K3.vec_width(f, item, *ptrs) == want


def test_plan_constants_match_the_kernel_source():
    with open(K3.SOURCE, encoding="utf-8") as fh:
        text = fh.read()
    found = re.search(r"constexpr int MAX_ACC = (\d+);", text)
    assert found and int(found.group(1)) == K3.MAX_ACC
    for group in K3.GROUPS:
        assert re.search(rf"g == {group}\) return pick_c<T, ROWS, V, "
                         rf"{group}>", text), group
    assert os.path.basename(K3.SOURCE) == "tiled_spmm.cu"


def test_run_plan_refuses_a_cpu_tensor():
    """``tiled_spmm`` takes the plain walk for a CPU tensor; the launch
    itself never does, so it raises instead of falling back."""
    rng = np.random.default_rng(0)
    s, r = rng.integers(0, 300, 2000), rng.integers(0, 300, 2000)
    g = graph_from_edges(s, r, 300, tiles=True, tile_mode="gather")
    x = torch.from_numpy(rng.standard_normal((300, 41)).astype(np.float32))
    before = K3.launches
    out = K3.tiled_spmm(g.tiled, x)
    assert out.shape == (g.tiled.num_tiles * g.tiled.tile_rows, 41)
    with pytest.raises(ValueError):
        K3.run_plan(g.tiled, x, K3.launch_plan(41, 1))
    assert K3.launches == before
