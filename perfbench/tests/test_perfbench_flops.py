"""The frozen arithmetic against hand counts at tiny shapes."""

import pytest

from perfbench.reference import flops


def test_sage_step_flops_by_hand():
    dims = [(2, 3), (3, 2)]
    # layer 0: forward and dW, 2 * 4 rows * (2 * 2) * 3 each; layer 1 adds
    # dX: 3 * (2 * 4 * (2 * 3) * 2); sums: 5 edges * 2 once, 5 * 3 twice
    assert flops.step_flops("sage", dims, 4, 5) == 2 * 96 + 3 * 96 + 10 + 30
    assert flops.gemm_flops("sage", dims, 8) == 2 * 192 + 3 * 192


def test_gat_step_flops_by_hand():
    dims = [(3, 2, 2)]
    n, e = 4, 5
    gemm = 2 * 2 * n * 3 * 2 * 2            # forward and dW
    scores = 3 * (2 * 2 * n * 2 * 2)        # z . attn, dz, dattn
    edges = 2 * e * 2 * 2 * 3 + 8 * e * 2   # weighted sums, softmax
    assert flops.step_flops("gat", dims, n, e) == gemm + scores + edges
    assert flops.gemm_flops("gat", dims, 8) == 2 * 2 * 8 * 3 * 2 * 2


def test_segment_sum_bytes_by_hand():
    # 4 rows, 5 edges, 3 columns, indexed: offsets 5*4, indices 5*4, the
    # source rows 4*3*4, the output 4*3*4
    assert flops.segment_sum_bytes(4, 5, 3) == (20 + 20 + 48 + 48, 15)
    # per-edge values (no index) of 2 heads: offsets, 5*2*4 in, 4*2*4 out
    assert flops.segment_sum_bytes(4, 5, 1, 2, indexed=False) == (
        20 + 40 + 32, 10)
    # weighted, 2 heads, 3 columns: + the weights 5*2*4; multiply-adds
    assert flops.segment_sum_bytes(4, 5, 3, 2, weighted=True) == (
        20 + 20 + 40 + 96 + 96, 60)


@pytest.mark.parametrize("model,dims,count", [
    ("sage", [(2, 3), (3, 3), (3, 2)], 5),
    ("gat", [(3, 2, 2), (2, 4, 1)], 12)])
def test_segment_sums_per_step(model, dims, count):
    sums = flops.segment_sums(model, dims, 4, 5)
    assert len(sums) == count
    assert all(b > 0 and f > 0 for b, f in sums)


def test_least_seconds_takes_the_slower_bound():
    assert flops.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert flops.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert flops.least_seconds(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_sub_model_dims():
    cfg = {"n_hidden": 2048, "n_layers": 4, "n_heads": 8}
    assert flops.sage_dims(cfg, 100, 47, 8) == [
        (100, 256), (256, 256), (256, 256), (256, 256), (256, 47)]
    gat = {"n_hidden": 512, "n_layers": 2, "n_heads": 8}
    assert flops.gat_dims(gat, 602, 41, 2) == [(602, 256, 8), (256, 41, 1)]
