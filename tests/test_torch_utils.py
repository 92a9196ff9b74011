"""The port's utilities (``gist_tpu_torch/utils.py``) behave as the JAX
package's (``gist_tpu/utils.py``, whose tests are ``tests/test_utils.py``)
on the same inputs; the port's ``prefetch`` also hands a worker's
exception to the consumer, and its ``profile_trace`` writes a trace."""

import json
import os
import time

import pytest

import gist_tpu.utils as JUt
import gist_tpu_torch.utils as TUt

BOTH = pytest.mark.parametrize("ut", [JUt, TUt], ids=["jax", "torch"])


@BOTH
def test_prefetch_order_and_completion(ut):
    items = list(range(20))

    def slow_gen():
        for i in items:
            time.sleep(0.001)
            yield i

    assert list(ut.prefetch(slow_gen(), depth=3)) == items


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_prefetch_reraises_worker_exception():
    """The JAX version ends the stream silently on a worker error; the
    port delivers the items before it and then raises it."""
    def failing():
        yield 1
        yield 2
        raise KeyError("worker failed")

    got = []
    with pytest.raises(KeyError, match="worker failed"):
        for item in TUt.prefetch(failing()):
            got.append(item)
    assert got == [1, 2]
    assert list(JUt.prefetch(failing())) == [1, 2]


@BOTH
def test_step_timer_warmup(ut):
    t = ut.StepTimer(warmup=2)
    for _ in range(5):
        t.start()
        time.sleep(0.001)
        t.stop()
    assert len(t.durs) == 3
    assert t.mean > 0 and t.total == pytest.approx(sum(t.durs))
    assert t.edges_per_sec(1000) == pytest.approx(1000 / t.mean)
    assert ut.StepTimer().edges_per_sec(10) == 0.0


@BOTH
def test_jsonl_logger(ut, tmp_path):
    path = str(tmp_path / "sub" / "log.jsonl")
    lg = ut.JsonlLogger(path)
    lg.log(step=1, loss=0.5)
    lg.log(step=2, loss=0.25)
    recs = [json.loads(l) for l in open(path)]
    assert recs == [{"step": 1, "loss": 0.5}, {"step": 2, "loss": 0.25}]
    ut.JsonlLogger(None).log(x=1)    # None path is a no-op


@BOTH
def test_profile_trace_noop(ut):
    with ut.profile_trace(None):
        pass


def test_profile_trace_writes_chrome_trace(tmp_path):
    import torch
    with TUt.profile_trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.loads((tmp_path / "prof" / files[0]).read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])
