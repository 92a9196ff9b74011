"""The device readers and the breakdown on a made-up trace: what only a
card's profiler feeds them, checked by hand on the CPU."""

import pytest

from perfbench import harness, trace
from perfbench.reference import flops

S = 10 ** 9   # ns a second


def _record(ops, spans, rounds=((1000, 5000, 1200),), k=1):
    spec = harness.Spec(bench={}, workload={"name": "x"}, config={},
                        traffic={"num_subnet": k}, limits={})
    dims = [(100, 64), (64, 7)]
    return harness.Record(spec, "sage", dims, [list(rounds)], spans,
                          0, 10 * S, 10.0, 1.0, ops)


OPS = [("sm80_xmma_gemm_f32", 1 * S, 2 * S),
       ("segment_csr_kernel<float>", 2 * S, 3 * S),
       ("Memcpy HtoD", 5 * S, 6 * S),
       ("elementwise", 5 * S + S // 2, 7 * S)]
SPANS = [("burst", 0, 4 * S, True), ("merge", 4 * S, 10 * S, True),
         ("batch_build", 0, 10 * S, False)]


def test_busy_idle_and_gaps():
    assert trace.busy_intervals(OPS) == [(1 * S, 3 * S), (5 * S, 7 * S)]
    assert trace.idle_gaps(OPS, 0, 10 * S) == [
        (0, 1 * S), (3 * S, 5 * S), (7 * S, 10 * S)]
    rec = _record(OPS, SPANS)
    assert rec.busy_s() == 4.0
    read = harness._load("metrics", "device_idle_share").read
    assert read(rec) == pytest.approx(60.0)
    b = trace.breakdown(OPS, SPANS, 0, 10 * S)
    # each gap by the span open at its middle: 0-1 s burst, 3-5 s and
    # 7-10 s merge
    assert dict(b["idle_gaps"]) == pytest.approx({"burst": 1.0,
                                                  "merge": 5.0})
    assert b["device_ops"][0][1] == 1.5


def test_kernel_readers_by_hand():
    rec = _record(OPS, SPANS, k=2)
    peak = flops.PEAK_FLOPS["float32"]
    steps = 2
    launches = harness._load("metrics", "launches_per_substep").read(rec)
    assert launches == 3 / steps
    gemm = harness._load("metrics", "gemm_peak_share").read(rec)
    assert gemm == pytest.approx(100 * steps * flops.gemm_flops(
        "sage", rec.dims, 1200) / 1.0 / peak)
    s1 = harness._load("metrics", "s1_roofline").read(rec)
    least = steps * sum(flops.least_seconds(b, f) for b, f in
                        flops.segment_sums("sage", rec.dims, 1000, 5000))
    assert s1 == pytest.approx(100 * least / 1.0)
    mfu = harness._load("metrics", "step_mfu").read(rec)
    assert mfu == pytest.approx(100 * steps * flops.step_flops(
        "sage", rec.dims, 1000, 5000) / 4.0 / peak)


def test_device_readers_silent_without_a_trace():
    rec = _record(None, SPANS)
    for name in ("device_idle_share", "step_mfu", "launches_per_substep",
                 "gemm_peak_share", "s1_roofline"):
        assert harness._load("metrics", name).read(rec) is None
