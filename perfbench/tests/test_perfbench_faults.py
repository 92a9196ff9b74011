"""The check fails a broken timed path: each cell run past the look for
a card, with a fault planted in the program underneath, reads
``correct`` false; the lower-precision control (the program's own
bfloat16 path) does too, and the sound program passes.  A fault planted
for the whole run shows in the round compared after the window; merges
skipped after the first round show there too."""

import contextlib
import time

import pytest

from conftest import TINY_CELLS
from perfbench import calibrate, harness


@contextlib.contextmanager
def dropped_edge():
    """The batch builder loses the last induced edge of every batch."""
    from gist_tpu_torch.sampler import ClusterSampler
    orig = ClusterSampler.csr_subgraph

    def csr_subgraph(self, node_ids):
        s, r = orig(self, node_ids)
        return s[:-1], r[:-1]

    ClusterSampler.csr_subgraph = csr_subgraph
    try:
        yield
    finally:
        ClusterSampler.csr_subgraph = orig


@contextlib.contextmanager
def altered_merge():
    """The merge alters one merged weight."""
    from gist_tpu_torch.ist import slicing, ultrawide
    host, dev = ultrawide.merge_host, slicing.merge

    def merge_host(params, *a, **kw):
        out = host(params, *a, **kw)
        out["layers"][0]["w"][0, 0] += 1e-3
        return out

    def merge(params, *a, **kw):
        out = dev(params, *a, **kw)
        out["layers"][0]["w"][0, 0, 0] += 1e-3
        return out

    ultrawide.merge_host, slicing.merge = merge_host, merge
    try:
        yield
    finally:
        ultrawide.merge_host, slicing.merge = host, dev


@contextlib.contextmanager
def unhooked_optimizer():
    """Optimizer steps that no step hook sees, as in a captured burst."""
    from torch.optim import optimizer

    class Handle:
        def remove(self):
            pass

    pre, post = (optimizer.register_optimizer_step_pre_hook,
                 optimizer.register_optimizer_step_post_hook)
    optimizer.register_optimizer_step_pre_hook = lambda hook: Handle()
    optimizer.register_optimizer_step_post_hook = lambda hook: Handle()
    try:
        yield
    finally:
        (optimizer.register_optimizer_step_pre_hook,
         optimizer.register_optimizer_step_post_hook) = pre, post


FAULTS = {"frozen_step": (calibrate.frozen_step, None),
          "stale_merge": (calibrate.stale_merge, None),
          "unhooked_optimizer": (unhooked_optimizer, None),
          "half_batch": (calibrate.half_batch, None),
          "dropped_edge": (dropped_edge, None),
          "altered_merge": (altered_merge, None),
          "bf16_control": (contextlib.nullcontext, "bfloat16")}


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_reads_not_correct(tiny_root, tiny_cache, cpu, cell, fault):
    plant, dtype = FAULTS[fault]
    with plant():
        res = harness.run_cell(tiny_root, cell, 2 ** 31 + 3, 0.1, False,
                               time.perf_counter(), cpu, tiny_cache, dtype)
    assert res["correct"] is False
    failing = [k for k, c in res["checks"].items()
               if not c["value"] <= c["limit"]]
    assert failing, res["checks"]


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_sound_program_reads_correct(tiny_root, tiny_cache, cpu, cell):
    res = harness.run_cell(tiny_root, cell, 2 ** 31 + 3, 0.1, False,
                           time.perf_counter(), cpu, tiny_cache)
    assert res["correct"] is True


def test_capture_counts_each_optimizer_once_even_at_a_reused_address():
    import torch
    cap = harness.StepCapture()
    try:
        for k in range(3):
            w = torch.zeros(2, requires_grad=True)
            opt = torch.optim.Adam([w], lr=0.1)
            for _ in range(3):
                w.grad = torch.ones(2) * (k + 1)
                opt.step()
            del opt, w
    finally:
        cap.remove()
    assert len(cap.p0) == len(cap.g1) == len(cap.p3) == 3
    assert [float(g[0][0]) for g in cap.g1] == pytest.approx([1, 2, 3])
